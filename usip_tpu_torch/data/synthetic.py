"""Synthetic data with no downloads (counterpart of
``usip_tpu/data/synthetic.py:12-273``; the port keeps its own copy):
``SyntheticDataset``, procedurally generated shapes with analytic normals
(the ``--synthetic`` tree); ``build_synthetic_kitti_tree``, LiDAR-like
scans of a persistent world written in the KITTI tree's layout; and the
indoor trees (``:275-660``): ``build_synthetic_scenenn_tree``, RGB-D-like
frame scans of a room for the lite detector and the indoor descriptor, and
``build_synthetic_match3d_fragments``, 3DMatch-style fragments with their
``gt.log``/``gt.info``. Same seed, same bytes as usip_tpu's."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def _unit(v, axis=-1):
    return v / (np.linalg.norm(v, axis=axis, keepdims=True) + 1e-12)


def sample_shape(rng: np.random.Generator, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """One random shape (sphere/box/cylinder mix) -> (pc (n,3), sn (n,3))."""
    kind = rng.integers(0, 3)
    if kind == 0:  # sphere with radial normals, mild radius modulation
        d = _unit(rng.normal(size=(n, 3)))
        r = 1.0 + 0.2 * np.sin(4 * d[:, :1]) * np.cos(4 * d[:, 1:2])
        pc = d * r
        sn = d
    elif kind == 1:  # box surface
        face = rng.integers(0, 6, size=n)
        uv = rng.uniform(-1, 1, size=(n, 2))
        pc = np.zeros((n, 3))
        sn = np.zeros((n, 3))
        axis = face % 3
        sign = np.where(face < 3, 1.0, -1.0)
        for i in range(n):
            a = axis[i]
            others = [j for j in range(3) if j != a]
            pc[i, a] = sign[i]
            pc[i, others[0]], pc[i, others[1]] = uv[i]
            sn[i, a] = sign[i]
    else:  # cylinder with caps
        t = rng.uniform(0, 2 * np.pi, size=n)
        side = rng.uniform(size=n) < 0.7
        pc = np.zeros((n, 3))
        sn = np.zeros((n, 3))
        z = rng.uniform(-1, 1, size=n)
        pc[side] = np.stack([np.cos(t[side]), np.sin(t[side]), z[side]], 1)
        sn[side] = np.stack([np.cos(t[side]), np.sin(t[side]),
                             np.zeros(side.sum())], 1)
        cap = ~side
        r = np.sqrt(rng.uniform(size=cap.sum()))
        zc = np.where(rng.uniform(size=cap.sum()) < 0.5, 1.0, -1.0)
        pc[cap] = np.stack([r * np.cos(t[cap]), r * np.sin(t[cap]), zc], 1)
        sn[cap] = np.stack([np.zeros(cap.sum()), np.zeros(cap.sum()), zc], 1)
    return pc.astype(np.float32), sn.astype(np.float32)


class SyntheticDataset:
    """Object-style siamese dataset: each item yields two independent samplings of
    the same shape (the modelnet recipe, modelnet_shrec_loader.py:245-247)."""

    def __init__(self, size: int = 64, input_pc_num: int = 1024,
                 surface_normal_len: int = 3, seed: int = 0,
                 oversample: int = 4):
        self.size = size
        self.n = input_pc_num
        self.sn_len = surface_normal_len
        rng = np.random.default_rng(seed)
        self._clouds = []
        for _ in range(size):
            pc, sn = sample_shape(rng, input_pc_num * oversample)
            self._clouds.append((pc, sn))

    def __len__(self):
        return self.size

    def _sample(self, rng: np.random.Generator, idx: int):
        pc, sn = self._clouds[idx]
        sel = rng.choice(pc.shape[0], self.n, replace=False)
        pc, sn = pc[sel], sn[sel]
        if self.sn_len == 0:
            sn = np.zeros((self.n, 0), np.float32)
        elif self.sn_len > 3:
            extra = np.zeros((self.n, self.sn_len - 3), np.float32)
            sn = np.concatenate([sn, extra], axis=1)
        return pc, sn

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        # NB: not Python hash() — string hashing is salted per process
        # (PYTHONHASHSEED), which made "deterministic" tests vary across runs.
        rng = np.random.default_rng(np.random.SeedSequence([idx, 0x5EED]))
        src_pc, src_sn = self._sample(rng, idx)
        dst_pc, dst_sn = self._sample(rng, idx)
        return {"src_pc": src_pc, "src_sn": src_sn,
                "dst_pc": dst_pc, "dst_sn": dst_sn}


# --------------------------------------------------------------------------
# Synthetic KITTI-style disk tree: LiDAR-like scans of a persistent world
# along a trajectory, written in the exact directory contract of the
# reference's preprocessed tree (np_0.20_20480_r90_sn + poses + calib +
# kitti-reg-test groundtruths). Lets the full kitti preset train/export/eval
# protocol, the cam->velodyne --coord-fix included, run end to end with no
# dataset downloads.


def _sample_box(rng, center, size, yaw, n):
    """Points + normals on an axis-yawed box surface."""
    face = rng.integers(0, 6, size=n)
    uv = rng.uniform(-0.5, 0.5, size=(n, 2))
    pc = np.zeros((n, 3))
    sn = np.zeros((n, 3))
    axis = face % 3
    sign = np.where(face < 3, 1.0, -1.0)
    for a in range(3):
        m = axis == a
        others = [j for j in range(3) if j != a]
        pc[m, a] = sign[m] * 0.5
        pc[m, others[0]] = uv[m, 0]
        pc[m, others[1]] = uv[m, 1]
        sn[m, a] = sign[m]
    pc = pc * size[None, :]
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    return pc @ R.T + center[None, :], sn @ R.T


def _make_world(rng, length: float):
    """Persistent world (velodyne/world frame, z-up): noisy ground + boxes +
    poles. Returns (points (N,3), normals (N,3), curvature (N,))."""
    pts, nrm, curv = [], [], []
    # ground strip, gentle height field
    ng = int(length * 50 * 8)
    gx = rng.uniform(-25, length + 25, size=ng)
    gy = rng.uniform(-25, 25, size=ng)
    gz = (0.15 * np.sin(0.13 * gx) * np.cos(0.21 * gy)
          + rng.normal(scale=0.02, size=ng))
    pts.append(np.stack([gx, gy, gz], 1))
    nrm.append(np.tile(np.array([0.0, 0, 1]), (ng, 1)))
    curv.append(np.full(ng, 0.01))
    # boxes (buildings/cars): corners are the stable structure USIP keys on
    n_boxes = max(int(length / 2.5), 8)
    for _ in range(n_boxes):
        c = np.array([rng.uniform(-10, length + 10),
                      rng.uniform(4, 22) * rng.choice([-1.0, 1.0]), 0.0])
        size = rng.uniform([0.8, 0.8, 1.0], [6.0, 6.0, 4.0])
        c[2] = size[2] / 2
        nb = int(200 + 60 * size.prod())
        p, s = _sample_box(rng, c, size, rng.uniform(0, np.pi), nb)
        pts.append(p + rng.normal(scale=0.015, size=p.shape))
        nrm.append(s)
        curv.append(np.full(nb, 0.02))
    # poles (trunks/signs)
    n_poles = max(int(length / 4), 6)
    for _ in range(n_poles):
        h = rng.uniform(2.5, 7.0)
        r = rng.uniform(0.12, 0.4)
        npl = int(150 * h)
        t = rng.uniform(0, 2 * np.pi, size=npl)
        z = rng.uniform(0, h, size=npl)
        cx = rng.uniform(-10, length + 10)
        cy = rng.uniform(3, 20) * rng.choice([-1.0, 1.0])
        p = np.stack([cx + r * np.cos(t), cy + r * np.sin(t), z], 1)
        s = np.stack([np.cos(t), np.sin(t), np.zeros(npl)], 1)
        pts.append(p + rng.normal(scale=0.01, size=p.shape))
        nrm.append(s)
        curv.append(np.full(npl, 0.15))
    return (np.concatenate(pts).astype(np.float32),
            np.concatenate(nrm).astype(np.float32),
            np.concatenate(curv).astype(np.float32))


def _trajectory(rng, n_frames: int, spacing: float):
    """Velodyne-frame poses along a gently curving path; z-up, sensor 1.7 m
    above ground. Returns (n, 4, 4)."""
    x = np.arange(n_frames) * spacing
    y = 2.5 * np.sin(0.02 * x) + rng.normal(scale=0.05, size=n_frames)
    dx = np.gradient(x)
    dy = np.gradient(y)
    yaw = np.arctan2(dy, dx)
    poses = np.tile(np.eye(4), (n_frames, 1, 1))
    c, s = np.cos(yaw), np.sin(yaw)
    poses[:, 0, 0], poses[:, 0, 1] = c, -s
    poses[:, 1, 0], poses[:, 1, 1] = s, c
    poses[:, 0, 3], poses[:, 1, 3], poses[:, 2, 3] = x, y, 1.7
    return poses


# synthetic velodyne->camera calib (x_cam = Tr @ x_velo): the KITTI-style
# axis permutation (cam x=-velo y, cam y=-velo z, cam z=velo x) + offset
SYNTH_TR = np.array([[0.0, -1, 0, 0.05],
                     [0.0, 0, -1, -0.08],
                     [1.0, 0, 0, 0.27],
                     [0.0, 0, 0, 1]])


def build_synthetic_kitti_tree(root: str, train_seqs=range(9),
                               test_seqs=(9, 10), frames_per_seq: int = 48,
                               test_frames_per_seq: int = 36,
                               target_points: int = 20480,
                               scan_radius: float = 45.0,
                               spacing: float = 1.5, seed: int = 0,
                               min_pair_spacing: float = 10.0) -> dict:
    """Write a synthetic KITTI odometry tree under ``root``: per-seq
    ``data_odometry_velodyne/numpy/<seq>/np_0.20_20480_r90_sn/*.npy`` (Nx8
    camera-frame: xyz + normal(3) + curvature + reflectance), ``poses``,
    ``calib/<seq>/calib.txt`` (synthetic Tr) and, for test seqs,
    ``kitti-reg-test/<seq>/groundtruths.txt`` (velodyne-frame relative poses
    >=10 m apart). Returns per-seq frame counts."""
    import os

    from usip_tpu_torch.data.loaders import KITTI_NP_FOLDER
    from usip_tpu_torch.data.preprocess import (build_test_pairs,
                                                write_groundtruths_txt)

    counts = {}
    tr_r, tr_t = SYNTH_TR[:3, :3], SYNTH_TR[:3, 3]
    for seq in list(train_seqs) + list(test_seqs):
        n_frames = test_frames_per_seq if seq in test_seqs else frames_per_seq
        rng = np.random.default_rng(np.random.SeedSequence([seed, seq]))
        length = n_frames * spacing
        w_pts, w_nrm, w_curv = _make_world(rng, length)
        poses = _trajectory(rng, n_frames, spacing)

        np_dir = os.path.join(root, "data_odometry_velodyne", "numpy",
                              f"{seq:02d}", KITTI_NP_FOLDER)
        pose_dir = os.path.join(root, "poses", f"{seq:02d}")
        calib_dir = os.path.join(root, "calib", f"{seq:02d}")
        for d in (np_dir, pose_dir, calib_dir):
            os.makedirs(d, exist_ok=True)

        for i in range(n_frames):
            t = poses[i, :3, 3]
            R = poses[i, :3, :3]
            d2 = np.sum((w_pts - t[None, :]) ** 2, axis=1)
            mask = d2 <= scan_radius * scan_radius
            p_w, n_w, c_w = w_pts[mask], w_nrm[mask], w_curv[mask]
            if p_w.shape[0] >= target_points:
                sel = rng.choice(p_w.shape[0], target_points, replace=False)
            else:
                sel = np.concatenate([
                    np.arange(p_w.shape[0]),
                    rng.choice(max(p_w.shape[0], 1),
                               target_points - p_w.shape[0])])
            p_w, n_w, c_w = p_w[sel], n_w[sel], c_w[sel]
            # sensor (velodyne) frame, then camera frame via the calib Tr
            p_v = (p_w - t[None, :]) @ R
            n_v = n_w @ R
            p_c = p_v @ tr_r.T + tr_t[None, :]
            n_c = n_v @ tr_r.T
            refl = rng.uniform(0, 0.99, size=(target_points, 1))
            frame = np.concatenate(
                [p_c, n_c, c_w[:, None], refl], axis=1).astype(np.float32)
            np.save(os.path.join(np_dir, f"{i:06d}.npy"), frame)
            # the reference trail stores camera poses
            np.savez(os.path.join(pose_dir, f"{i:06d}.npz"),
                     pose=poses[i] @ np.linalg.inv(SYNTH_TR))

        with open(os.path.join(calib_dir, "calib.txt"), "w") as f:
            for name in ("P0", "P1", "P2", "P3"):
                f.write(name + ": " + " ".join(
                    f"{v:.6e}" for v in np.eye(4)[:3].ravel()) + "\n")
            f.write("Tr: " + " ".join(
                f"{v:.6e}" for v in SYNTH_TR[:3].ravel()) + "\n")

        if seq in test_seqs:
            pairs = build_test_pairs(poses, min_pair_spacing)
            write_groundtruths_txt(
                os.path.join(root, "kitti-reg-test", f"{seq:02d}",
                             "groundtruths.txt"), poses, pairs)
        counts[seq] = n_frames
    return counts


# --------------------------------------------------------------------------
# Synthetic indoor trees: SceneNN-style RGB-D frame scans for training
# (frames_<mode>/*.npy + info_<mode>.pkl, the directory contract of
# data/scenenn_detector_loader.py:48-67 / scenenn_descriptor_loader.py:60-96)
# and 3DMatch-style fused fragments + gt.log/gt.info for the indoor
# fragment-registration protocol (eval_indoor/fullEvaluation.m:1-12,
# 3dmatch/register2Fragments.m:15-160). Lets the COMPLETE indoor pipeline —
# lite detector -> global-context descriptor (CGF loss) -> fragment
# registration -> recall/precision — run end to end with no downloads.


def _sample_plane(rng, n, origin, u, v, normal, eu, ev, noise=0.004):
    """n points on the rectangle origin + [0,eu]*u + [0,ev]*v."""
    a = rng.uniform(0, eu, size=n)
    b = rng.uniform(0, ev, size=n)
    p = (origin[None, :] + a[:, None] * u[None, :] + b[:, None] * v[None, :]
         + normal[None, :] * rng.normal(scale=noise, size=(n, 1)))
    return p, np.tile(np.asarray(normal, float), (n, 1))


def _rand_rotation(rng):
    """Uniform random 3-D rotation (QR of a gaussian, sign-fixed)."""
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q *= np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q


def _make_room(rng, density: float = 260.0):
    """Indoor world (world frame, z-up): floor/ceiling/4 walls + dense,
    ASYMMETRIC clutter — floor boxes (some stacked), wall-mounted boxes,
    fully-tilted boxes, spheres, vertical cylinders, and horizontal pipes.

    Bare planes are kept sparse relative to objects on purpose: descriptor
    kNN matching over a mostly-planar symmetric room lets wall-sliding /
    90-degree-symmetric false alignments collect more match support than the
    true transform (RANSAC then registers the symmetry, failing the Choi
    et al. pose-error gate p<=0.04 while passing the inlier gates) — the
    registration protocol needs rooms whose 0.75 m-ball local geometry is
    discriminative, like real 3DMatch interiors.

    Returns (points (N,3), normals (N,3), curvature (N,), (w, d, h))."""
    w = rng.uniform(4.5, 7.0)
    d = rng.uniform(4.5, 7.0)
    if abs(w - d) < 0.6:  # break the square-room 90-degree wall symmetry
        d += np.sign(d - w + 1e-9) * 0.6
    h = rng.uniform(2.5, 3.0)
    ex = np.eye(3)
    pts, nrm, curv = [], [], []
    plane_density = 0.45 * density
    obj_density = 2.2 * density
    planes = [
        # origin, u, v, inward normal, extents
        (np.zeros(3), ex[0], ex[1], ex[2], w, d),          # floor
        (np.array([0, 0, h]), ex[0], ex[1], -ex[2], w, d),  # ceiling
        (np.zeros(3), ex[0], ex[2], ex[1], w, h),           # wall y=0
        (np.array([0, d, 0]), ex[0], ex[2], -ex[1], w, h),  # wall y=d
        (np.zeros(3), ex[1], ex[2], ex[0], d, h),           # wall x=0
        (np.array([w, 0, 0]), ex[1], ex[2], -ex[0], d, h),  # wall x=w
    ]
    for origin, u, v, n_vec, eu, ev in planes:
        n_pts = int(plane_density * eu * ev)
        p, s = _sample_plane(rng, n_pts, origin, u, v, n_vec, eu, ev)
        pts.append(p)
        nrm.append(s)
        curv.append(np.full(n_pts, 0.005))

    def add_box(c, size, R=None, yaw=None):
        nb = max(int(obj_density * 2 * (size[0] * size[1] + size[0] * size[2]
                                        + size[1] * size[2])), 64)
        p, s = _sample_box(rng, c, size, 0.0 if yaw is None else yaw, nb)
        if R is not None:
            p = (p - c[None, :]) @ R.T + c[None, :]
            s = s @ R.T
        pts.append(p + rng.normal(scale=0.006, size=p.shape))
        nrm.append(s)
        curv.append(np.full(nb, 0.02))
        return c, size

    # floor furniture (tables, cabinets, sofas), some with a smaller box
    # stacked on top (object-on-table structure)
    for _ in range(rng.integers(12, 19)):
        size = rng.uniform([0.25, 0.25, 0.25], [1.8, 1.8, 1.4])
        c = np.array([rng.uniform(0.4 + size[0] / 2, w - 0.4 - size[0] / 2),
                      rng.uniform(0.4 + size[1] / 2, d - 0.4 - size[1] / 2),
                      size[2] / 2])
        add_box(c, size, yaw=rng.uniform(0, np.pi))
        if rng.uniform() < 0.4:
            top = rng.uniform([0.12, 0.12, 0.12], size * [0.7, 0.7, 1.0])
            c2 = c + np.array([rng.uniform(-0.2, 0.2), rng.uniform(-0.2, 0.2),
                               size[2] / 2 + top[2] / 2])
            add_box(c2, top, yaw=rng.uniform(0, np.pi))
    # wall-mounted boxes (shelves, cabinets, window sills) at varied heights
    for _ in range(rng.integers(6, 11)):
        size = rng.uniform([0.25, 0.12, 0.2], [1.6, 0.5, 0.9])
        wall = rng.integers(0, 4)
        along = rng.uniform(0.5, (w if wall < 2 else d) - 0.5)
        zc = rng.uniform(0.4, h - 0.6)
        if wall == 0:
            c, yaw = np.array([along, size[1] / 2, zc]), 0.0
        elif wall == 1:
            c, yaw = np.array([along, d - size[1] / 2, zc]), 0.0
        elif wall == 2:
            c, yaw = np.array([size[1] / 2, along, zc]), np.pi / 2
        else:
            c, yaw = np.array([w - size[1] / 2, along, zc]), np.pi / 2
        add_box(c, size, yaw=yaw)
    # fully-tilted boxes (leaning objects): orientation diversity
    for _ in range(rng.integers(3, 6)):
        size = rng.uniform([0.2, 0.2, 0.2], [0.9, 0.9, 0.9])
        c = np.array([rng.uniform(0.8, w - 0.8), rng.uniform(0.8, d - 0.8),
                      rng.uniform(0.3, 1.8)])
        add_box(c, size, R=_rand_rotation(rng))
    # spheres (globes, balls): curvature signature planes/boxes lack
    for _ in range(rng.integers(3, 6)):
        r = rng.uniform(0.12, 0.45)
        c = np.array([rng.uniform(0.6, w - 0.6), rng.uniform(0.6, d - 0.6),
                      rng.uniform(r, 1.8)])
        ns = max(int(obj_density * 4 * np.pi * r * r), 64)
        dirs = _unit(rng.normal(size=(ns, 3)))
        pts.append(c[None, :] + r * dirs + rng.normal(scale=0.004,
                                                      size=(ns, 3)))
        nrm.append(dirs)
        curv.append(np.full(ns, 0.1))
    # vertical cylinders (lamps, bins)
    for _ in range(rng.integers(2, 5)):
        hgt = rng.uniform(0.5, 1.6)
        r = rng.uniform(0.08, 0.3)
        npl = max(int(obj_density * 2 * np.pi * r * hgt), 48)
        t = rng.uniform(0, 2 * np.pi, size=npl)
        z = rng.uniform(0, hgt, size=npl)
        cx, cy = rng.uniform(0.6, w - 0.6), rng.uniform(0.6, d - 0.6)
        p = np.stack([cx + r * np.cos(t), cy + r * np.sin(t), z], 1)
        s = np.stack([np.cos(t), np.sin(t), np.zeros(npl)], 1)
        pts.append(p + rng.normal(scale=0.004, size=p.shape))
        nrm.append(s)
        curv.append(np.full(npl, 0.12))
    # horizontal pipes along walls near the ceiling
    for _ in range(rng.integers(1, 3)):
        r = rng.uniform(0.05, 0.12)
        zc = rng.uniform(h - 0.5, h - 0.15)
        along_x = rng.uniform() < 0.5
        ln = (w if along_x else d) - 1.0
        npl = max(int(obj_density * 2 * np.pi * r * ln), 48)
        t = rng.uniform(0, 2 * np.pi, size=npl)
        a = rng.uniform(0.5, 0.5 + ln, size=npl)
        off = rng.uniform(0.3, 0.8)
        if along_x:
            cy = off if rng.uniform() < 0.5 else d - off
            p = np.stack([a, cy + r * np.cos(t), zc + r * np.sin(t)], 1)
            s = np.stack([np.zeros(npl), np.cos(t), np.sin(t)], 1)
        else:
            cx = off if rng.uniform() < 0.5 else w - off
            p = np.stack([cx + r * np.cos(t), a, zc + r * np.sin(t)], 1)
            s = np.stack([np.cos(t), np.zeros(npl), np.sin(t)], 1)
        pts.append(p + rng.normal(scale=0.004, size=p.shape))
        nrm.append(s)
        curv.append(np.full(npl, 0.12))
    return (np.concatenate(pts).astype(np.float32),
            np.concatenate(nrm).astype(np.float32),
            np.concatenate(curv).astype(np.float32), (w, d, h))


def _camera_pose(cam: np.ndarray, target: np.ndarray) -> np.ndarray:
    """4x4 cam->world pose with +z = view direction (look-at), x right,
    y down — the RGB-D convention."""
    z = _unit(target - cam)
    up = np.array([0.0, 0, 1])
    x = _unit(np.cross(z, up))
    y = np.cross(z, x)
    T = np.eye(4)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = x, y, z, cam
    return T


def _view_points(w_pts, cam, view_dir, radius: float, cos_half_fov: float):
    """Mask of world points inside the camera's cone."""
    rel = w_pts - cam[None, :]
    dist = np.linalg.norm(rel, axis=1)
    along = rel @ view_dir
    return (dist < radius) & (along > cos_half_fov * np.maximum(dist, 1e-9))


def _fixed_count(rng, arrays, target: int):
    n = arrays[0].shape[0]
    if n >= target:
        sel = rng.choice(n, target, replace=False)
    else:
        sel = np.concatenate([np.arange(n),
                              rng.choice(max(n, 1), target - n)])
    return [a[sel] for a in arrays]


def _frame_features(p_local, n_local, c_local):
    return np.concatenate([p_local, n_local, c_local[:, None]],
                          axis=1).astype(np.float32)


def build_synthetic_scenenn_tree(root: str, train_frames: int = 48,
                                 test_frames: int = 16,
                                 target_points: int = 15000,
                                 seed: int = 0) -> dict:
    """Write a synthetic SceneNN tree under ``root``: per mode
    ``frames_<mode>/<i>.npy`` (Nx7 camera-frame: xyz + normal(3) + curvature)
    and ``info_<mode>.pkl`` with the reference's keys — ``pairs_np`` (P, 2)
    [anchor, positive], ``icp_np`` (P, 4, 4) anchor->positive alignments
    (exact here, ICP-refined in the real set), ``positive_list``,
    ``sample_num`` (scenenn_detector_loader.py:48-67).

    Frames are overlapping view-cone scans of one persistent room along an
    interior orbit, each stored in its own camera frame — so descriptor
    training must learn viewpoint-invariant local geometry exactly as on the
    real set."""
    import os
    import pickle

    counts = {}
    for mode, n_frames, mode_seed in (("train", train_frames, 0),
                                      ("test", test_frames, 1)):
        rng = np.random.default_rng(np.random.SeedSequence(
            [seed, 0x1D008, mode_seed]))
        w_pts, w_nrm, w_curv, (w, d, h) = _make_room(rng)
        center = np.array([w / 2, d / 2, rng.uniform(1.3, 1.6)])
        theta = (np.linspace(0, 2 * np.pi, n_frames, endpoint=False)
                 + rng.normal(scale=0.02, size=n_frames))
        cams = center[None, :] + np.stack(
            [0.28 * w * np.cos(theta), 0.28 * d * np.sin(theta),
             rng.normal(scale=0.05, size=n_frames)], 1)
        # look outward past the orbit so consecutive cones overlap heavily
        targets = center[None, :] + np.stack(
            [0.9 * w * np.cos(theta + 0.35), 0.9 * d * np.sin(theta + 0.35),
             np.full(n_frames, -0.4)], 1)
        poses = np.stack([_camera_pose(c, t) for c, t in zip(cams, targets)])

        frame_dir = os.path.join(root, f"frames_{mode}")
        os.makedirs(frame_dir, exist_ok=True)
        masks = []
        for i in range(n_frames):
            view = poses[i, :3, 2]
            mask = _view_points(w_pts, cams[i], view, radius=6.0,
                                cos_half_fov=np.cos(np.deg2rad(60.0)))
            masks.append(mask)
            p, s, c = _fixed_count(
                rng, [w_pts[mask], w_nrm[mask], w_curv[mask]], target_points)
            R = poses[i, :3, :3]
            p_local = (p - cams[i][None, :]) @ R       # world -> camera
            n_local = s @ R
            np.save(os.path.join(frame_dir, f"{i}.npy"),
                    _frame_features(p_local, n_local, c))

        # positives: nearby orbit frames gated by MEASURED view overlap (the
        # real set selects pairs by reconstruction overlap); fixed angular
        # offsets break down on small orbits where one step is tens of degrees
        pairs, icps = [], []
        positive_list = [[] for _ in range(n_frames)]
        for i in range(n_frames):
            chosen = []
            for off in (-3, -2, -1, 1, 2, 3):
                j = (i + off) % n_frames
                if j == i or j in chosen:
                    continue
                olap = ((masks[i] & masks[j]).sum()
                        / max(int(masks[i].sum()), 1))
                if olap >= 0.45:
                    chosen.append(j)
            if not chosen:  # degenerate tiny orbit: best immediate neighbor
                cands = [(i + 1) % n_frames, (i - 1) % n_frames]
                chosen = [max(cands, key=lambda j: (masks[i] & masks[j]).sum())]
            for j in chosen:
                positive_list[i].append(j)
                pairs.append([i, j])
                icps.append(np.linalg.inv(poses[j]) @ poses[i])
        info = {"pairs_np": np.asarray(pairs, np.int64),
                "icp_np": np.asarray(icps, np.float64),
                "positive_list": positive_list,
                "sample_num": n_frames}
        with open(os.path.join(root, f"info_{mode}.pkl"), "wb") as f:
            pickle.dump(info, f)
        counts[mode] = n_frames
    return counts


def build_synthetic_match3d_fragments(root: str,
                                      scenes: int = 2,
                                      fragments_per_scene: int = 8,
                                      target_points: int = 20000,
                                      overlap_gate: float = 0.30,
                                      seed: int = 0) -> dict:
    """Write 3DMatch-style eval fragments + ground truth under ``root``:
    ``fragments/<scene>/<i>.npy`` (Nx7 fragment-local) and
    ``gt/<scene>-evaluation/gt.log`` + ``gt.info`` — the layout consumed by
    ``eval-indoor`` / ``eval/indoor.py`` (mrLoadLog/mrLoadInfo; the real set's
    contract per 3dmatch/evaluate.m).

    Each fragment is a wide-cone fused submap of the scene's room from one
    viewpoint; gt entries cover fragment pairs whose gt-aligned overlap
    exceeds ``overlap_gate``, with the Choi et al. information matrix computed
    from the overlapping points (register2Fragments.m:78-91)."""
    import os

    from scipy.spatial import cKDTree

    from usip_tpu_torch.eval.indoor import LogEntry, information_matrix

    out = {}
    for s_idx in range(scenes):
        scene = f"synth-scene{s_idx}"
        rng = np.random.default_rng(np.random.SeedSequence(
            [seed, 0x3D0A7C, s_idx]))
        w_pts, w_nrm, w_curv, (w, d, h) = _make_room(rng)
        center = np.array([w / 2, d / 2, rng.uniform(1.3, 1.6)])
        theta = (np.linspace(0, 2 * np.pi, fragments_per_scene,
                             endpoint=False)
                 + rng.normal(scale=0.03, size=fragments_per_scene))
        cams = center[None, :] + np.stack(
            [0.22 * w * np.cos(theta), 0.22 * d * np.sin(theta),
             rng.normal(scale=0.04, size=fragments_per_scene)], 1)
        targets = center[None, :] + np.stack(
            [0.9 * w * np.cos(theta + 0.3), 0.9 * d * np.sin(theta + 0.3),
             np.full(fragments_per_scene, -0.3)], 1)
        poses = np.stack([_camera_pose(c, t) for c, t in zip(cams, targets)])

        frag_dir = os.path.join(root, "fragments", scene)
        os.makedirs(frag_dir, exist_ok=True)
        locals_w = []  # world-frame point sets per fragment (for gt overlap)
        for i in range(fragments_per_scene):
            view = poses[i, :3, 2]
            mask = _view_points(w_pts, cams[i], view, radius=7.5,
                                cos_half_fov=np.cos(np.deg2rad(75.0)))
            p, s, c = _fixed_count(
                rng, [w_pts[mask], w_nrm[mask], w_curv[mask]], target_points)
            locals_w.append(p)
            R = poses[i, :3, :3]
            p_local = (p - cams[i][None, :]) @ R
            n_local = s @ R
            np.save(os.path.join(frag_dir, f"{i}.npy"),
                    _frame_features(p_local, n_local, c))

        # gt.log / gt.info over sufficiently-overlapping pairs
        gt_dir = os.path.join(root, "gt", f"{scene}-evaluation")
        os.makedirs(gt_dir, exist_ok=True)
        log_entries, info_entries = [], []
        n = fragments_per_scene
        # overlap radius adapts to sampling density: two independent
        # samplings of the SAME surface have NN distances ~ the per-fragment
        # point spacing, so a fixed 0.1 m only works at production density
        spacing = np.median(cKDTree(locals_w[0]).query(locals_w[0], k=2)[0][:, 1])
        r_olap = max(0.1, 3.0 * float(spacing))
        for i in range(n):
            tree_i = cKDTree(locals_w[i])
            for j in range(i + 1, n):
                dists, _ = tree_i.query(locals_w[j], k=1,
                                        distance_upper_bound=r_olap)
                olap = np.count_nonzero(np.isfinite(dists)) / len(dists)
                if olap < overlap_gate:
                    continue
                # transform aligning fragment j into fragment i's frame
                trans = np.linalg.inv(poses[i]) @ poses[j]
                # info matrix over fragment i's points inside the overlap
                dists_i, _ = cKDTree(locals_w[j]).query(
                    locals_w[i], k=1, distance_upper_bound=r_olap)
                ov_i = locals_w[i][np.isfinite(dists_i)]
                R_i = poses[i][:3, :3]
                ov_i_local = (ov_i - poses[i][:3, 3][None, :]) @ R_i
                sub = ov_i_local[rng.choice(
                    len(ov_i_local), min(len(ov_i_local), 5000),
                    replace=False)]
                log_entries.append(LogEntry(i, j, n, trans))
                info_entries.append(LogEntry(i, j, n, np.eye(4),
                                             information=information_matrix(
                                                 sub)))
        with open(os.path.join(gt_dir, "gt.log"), "w") as f:
            for e in log_entries:
                f.write(f"{e.i}\t{e.j}\t{e.n}\n")
                for row in e.trans:
                    f.write("\t".join(f"{v:.10f}" for v in row) + "\n")
        with open(os.path.join(gt_dir, "gt.info"), "w") as f:
            for e in info_entries:
                f.write(f"{e.i}\t{e.j}\t{e.n}\n")
                for row in e.information:
                    f.write("\t".join(f"{v:.8f}" for v in row) + "\n")
        out[scene] = {"fragments": n, "gt_pairs": len(log_entries)}
    return out
