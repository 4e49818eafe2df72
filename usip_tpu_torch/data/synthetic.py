"""Synthetic data with no downloads (counterpart of
``usip_tpu/data/synthetic.py:12-273``; the port keeps its own copy):
``SyntheticDataset``, procedurally generated shapes with analytic normals
(the ``--synthetic`` tree), and ``build_synthetic_kitti_tree``, LiDAR-like
scans of a persistent world written in the KITTI tree's layout. Same seed,
same bytes as usip_tpu's. The indoor tree builders are not ported."""

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
