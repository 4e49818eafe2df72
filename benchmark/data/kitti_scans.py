"""LiDAR-like KITTI scans from a seed: a persistent world of ground, boxes
and poles, scanned along a gently curving trajectory, each scan in the
camera frame of KITTI's preprocessed tree (``np_0.20_20480_r90_sn``: N x 8
columns xyz, normal, curvature, reflectance).

A frozen copy of the port's synthetic KITTI tree (``data/synthetic.py
build_synthetic_kitti_tree``), cut to what the cells read: the detector
loader's ``.npy`` scans, the descriptor loader's poses, and scans in
memory for the detect and serve cells.
"""

from __future__ import annotations

import os
import shutil
from typing import Iterator, Tuple

import numpy as np

# the KITTI-style velodyne -> camera calibration (cam x = -velo y, cam y =
# -velo z, cam z = velo x, plus an offset)
TR = np.array([[0.0, -1, 0, 0.05],
               [0.0, 0, -1, -0.08],
               [1.0, 0, 0, 0.27],
               [0.0, 0, 0, 1]])
NP_FOLDER = "np_0.20_20480_r90_sn"


def _sample_box(rng, center, size, yaw, n):
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


def make_world(rng, length: float):
    """Ground with a gentle height field, boxes and poles along a strip of
    ``length`` m: points, normals, curvature (world frame, z up)."""
    pts, nrm, curv = [], [], []
    ng = int(length * 50 * 8)
    gx = rng.uniform(-25, length + 25, size=ng)
    gy = rng.uniform(-25, 25, size=ng)
    gz = (0.15 * np.sin(0.13 * gx) * np.cos(0.21 * gy)
          + rng.normal(scale=0.02, size=ng))
    pts.append(np.stack([gx, gy, gz], 1))
    nrm.append(np.tile(np.array([0.0, 0, 1]), (ng, 1)))
    curv.append(np.full(ng, 0.01))
    for _ in range(max(int(length / 2.5), 8)):
        c = np.array([rng.uniform(-10, length + 10),
                      rng.uniform(4, 22) * rng.choice([-1.0, 1.0]), 0.0])
        size = rng.uniform([0.8, 0.8, 1.0], [6.0, 6.0, 4.0])
        c[2] = size[2] / 2
        nb = int(200 + 60 * size.prod())
        p, s = _sample_box(rng, c, size, rng.uniform(0, np.pi), nb)
        pts.append(p + rng.normal(scale=0.015, size=p.shape))
        nrm.append(s)
        curv.append(np.full(nb, 0.02))
    for _ in range(max(int(length / 4), 6)):
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


def trajectory(rng, n_frames: int, spacing: float) -> np.ndarray:
    """Velodyne-frame poses ``(n, 4, 4)`` along a gently curving path, the
    sensor 1.7 m above the ground."""
    x = np.arange(n_frames) * spacing
    y = 2.5 * np.sin(0.02 * x) + rng.normal(scale=0.05, size=n_frames)
    yaw = np.arctan2(np.gradient(y), np.gradient(x))
    poses = np.tile(np.eye(4), (n_frames, 1, 1))
    c, s = np.cos(yaw), np.sin(yaw)
    poses[:, 0, 0], poses[:, 0, 1] = c, -s
    poses[:, 1, 0], poses[:, 1, 1] = s, c
    poses[:, 0, 3], poses[:, 1, 3], poses[:, 2, 3] = x, y, 1.7
    return poses


def sequence(seed: int, seq: int, n_frames: int, points: int,
             scan_radius: float = 45.0, spacing: float = 1.5
             ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """The scans of one sequence: ``(frame (points, 8) float32 camera
    frame, velodyne pose (4, 4))`` a frame."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, seq]))
    w_pts, w_nrm, w_curv = make_world(rng, n_frames * spacing)
    poses = trajectory(rng, n_frames, spacing)
    tr_r, tr_t = TR[:3, :3], TR[:3, 3]
    for i in range(n_frames):
        t, R = poses[i, :3, 3], poses[i, :3, :3]
        d2 = np.sum((w_pts - t[None, :]) ** 2, axis=1)
        mask = d2 <= scan_radius * scan_radius
        p_w, n_w, c_w = w_pts[mask], w_nrm[mask], w_curv[mask]
        if p_w.shape[0] >= points:
            sel = rng.choice(p_w.shape[0], points, replace=False)
        else:
            sel = np.concatenate([np.arange(p_w.shape[0]), rng.choice(
                max(p_w.shape[0], 1), points - p_w.shape[0])])
        p_w, n_w, c_w = p_w[sel], n_w[sel], c_w[sel]
        p_v = (p_w - t[None, :]) @ R
        n_v = n_w @ R
        refl = rng.uniform(0, 0.99, size=(points, 1))
        frame = np.concatenate([p_v @ tr_r.T + tr_t[None, :], n_v @ tr_r.T,
                                c_w[:, None], refl], axis=1)
        yield frame.astype(np.float32), poses[i]


def write_tree(root: str, seed: int, sequences: int, frames_per_seq: int,
               points: int, poses: bool = False) -> int:
    """A KITTI odometry tree of the train sequences ``0 .. sequences-1``
    under ``root`` (emptied first): ``data_odometry_velodyne/numpy/<seq>/
    np_0.20_20480_r90_sn/<frame>.npy`` and, with ``poses``, the camera-frame
    poses ``poses/<seq>/<frame>.npz``. Returns the bytes written."""
    if os.path.isdir(root):
        shutil.rmtree(root)
    written = 0
    inv_tr = np.linalg.inv(TR)
    for seq in range(sequences):
        np_dir = os.path.join(root, "data_odometry_velodyne", "numpy",
                              f"{seq:02d}", NP_FOLDER)
        pose_dir = os.path.join(root, "poses", f"{seq:02d}")
        os.makedirs(np_dir)
        if poses:
            os.makedirs(pose_dir)
        for i, (frame, pose) in enumerate(
                sequence(seed, seq, frames_per_seq, points)):
            np.save(os.path.join(np_dir, f"{i:06d}.npy"), frame)
            written += frame.nbytes
            if poses:
                np.savez(os.path.join(pose_dir, f"{i:06d}.npz"),
                         pose=pose @ inv_tr)
    return written


def scan_pool(seed: int, count: int, points: int, frames_per_seq: int = 16
              ) -> np.ndarray:
    """``count`` scans in memory ``(count, points, 8)`` float32, from
    sequences of ``frames_per_seq`` frames."""
    frames = []
    seq = 0
    while len(frames) < count:
        for frame, _ in sequence(seed, seq, frames_per_seq, points):
            frames.append(frame)
            if len(frames) == count:
                break
        seq += 1
    return np.stack(frames)
