"""Dataset preprocessing: raw scans -> the .npy trees the loaders consume
(counterpart of ``usip_tpu/data/preprocess.py``; the port keeps its own
copy).

Python replacement of the reference's MATLAB data preparation
(evaluation/matlab/eval_outdoor/kitti/kitti_data_prepare/kitti_test_prepare.m:
0.2 m voxel-grid downsample, surface normals, r<90 m filter, ~10 m-spaced
registration test pairs; header :1-8) plus the np_0.20_20480_r90_sn folder
contract of data/kitti_detector_loader.py:32-33: the voxel grid and PCA
surface normals, the raw KITTI scan preparation (``prepare_lidar_scan``,
``read_velodyne_bin``, ``build_kitti_numpy_tree``; the command is ``python
-m usip_tpu_torch.prepare_kitti``), the registration test pairs and their
ground-truth table, and the rotated-ModelNet repeatability tree.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
from scipy.spatial import cKDTree


def voxel_downsample(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """Average points (and any extra channels) within each voxel."""
    coords = np.floor(points[:, :3] / voxel_size).astype(np.int64)
    # pack voxel coords into one key
    mins = coords.min(axis=0)
    coords = coords - mins
    dims = coords.max(axis=0) + 1
    keys = (coords[:, 0] * dims[1] + coords[:, 1]) * dims[2] + coords[:, 2]
    order = np.argsort(keys)
    keys_sorted = keys[order]
    pts_sorted = points[order]
    boundaries = np.nonzero(np.diff(keys_sorted))[0] + 1
    groups = np.split(pts_sorted, boundaries)
    return np.stack([g.mean(axis=0) for g in groups])


def estimate_normals(points: np.ndarray, k: int = 16,
                     orient_towards: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """PCA surface normals + curvature from k nearest neighbors.

    Returns (normals (N, 3), curvature (N,) = l3 / (l1+l2+l3)). Normals are
    oriented towards ``orient_towards`` (default: the origin — the sensor
    position for LiDAR scans).
    """
    n = points.shape[0]
    tree = cKDTree(points)
    _, idx = tree.query(points, k=min(k, n))
    neigh = points[idx]                         # (N, k, 3)
    centered = neigh - neigh.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", centered, centered) / idx.shape[1]
    evals, evecs = np.linalg.eigh(cov)          # ascending
    normals = evecs[:, :, 0]                    # smallest eigenvector
    curvature = evals[:, 0] / np.maximum(evals.sum(axis=1), 1e-12)
    target = (np.zeros(3) if orient_towards is None else orient_towards)
    to_target = target[None, :] - points
    flip = np.sum(normals * to_target, axis=1) < 0
    normals[flip] = -normals[flip]
    return normals.astype(np.float32), curvature.astype(np.float32)


def prepare_lidar_scan(xyz_reflectance: np.ndarray, voxel_size: float = 0.2,
                       target_points: int = 20480, max_radius: float = 90.0,
                       normal_k: int = 16) -> np.ndarray:
    """One velodyne scan -> Nx8 array (x, y, z, nx, ny, nz, curvature,
    reflectance) matching the kitti numpy folder contract."""
    pts = xyz_reflectance
    r = np.linalg.norm(pts[:, :3], axis=1)
    pts = pts[r <= max_radius]
    down = voxel_downsample(pts, voxel_size)
    if down.shape[0] > target_points:
        idx = np.random.default_rng(0).choice(down.shape[0], target_points,
                                              replace=False)
        down = down[idx]
    normals, curvature = estimate_normals(down[:, :3], k=normal_k)
    refl = down[:, 3] if down.shape[1] > 3 else np.zeros(down.shape[0])
    return np.concatenate([
        down[:, :3].astype(np.float32), normals, curvature[:, None],
        refl[:, None].astype(np.float32)], axis=1)


def read_velodyne_bin(path: str) -> np.ndarray:
    """KITTI velodyne .bin -> (N, 4) x, y, z, reflectance."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def build_kitti_numpy_tree(velodyne_dir: str, poses_file: str, out_root: str,
                           seq: int, calib_tr: Optional[np.ndarray] = None,
                           voxel_size: float = 0.2, target_points: int = 20480,
                           max_radius: float = 90.0,
                           limit: Optional[int] = None) -> int:
    """Build <out_root>/data_odometry_velodyne/numpy/<seq>/np_0.20_20480_r90_sn/
    plus <out_root>/poses/<seq>/<frame>.npz from raw KITTI odometry data.

    ``poses_file`` is the odometry poses txt (12 floats/line, cam frame);
    ``calib_tr`` the velodyne->cam transform if clouds should be stored in the
    camera frame like the reference's tree.
    """
    from usip_tpu_torch.data.loaders import KITTI_NP_FOLDER
    np_dir = os.path.join(out_root, "data_odometry_velodyne", "numpy",
                          f"{seq:02d}", KITTI_NP_FOLDER)
    pose_dir = os.path.join(out_root, "poses", f"{seq:02d}")
    os.makedirs(np_dir, exist_ok=True)
    os.makedirs(pose_dir, exist_ok=True)
    poses = np.loadtxt(poses_file).reshape(-1, 3, 4)
    files = sorted(f for f in os.listdir(velodyne_dir) if f.endswith(".bin"))
    if limit:
        files = files[:limit]
    for i, fn in enumerate(files):
        raw = read_velodyne_bin(os.path.join(velodyne_dir, fn))
        if calib_tr is not None:
            xyz1 = np.concatenate(
                [raw[:, :3], np.ones((raw.shape[0], 1), np.float32)], axis=1)
            cam = (calib_tr @ xyz1.T).T[:, :3]
            raw = np.concatenate([cam, raw[:, 3:4]], axis=1)
        out = prepare_lidar_scan(raw, voxel_size, target_points, max_radius)
        np.save(os.path.join(np_dir, f"{i:06d}.npy"), out)
        pose = np.eye(4)
        pose[:3, :4] = poses[i]
        np.savez(os.path.join(pose_dir, f"{i:06d}.npz"), pose=pose)
    return len(files)


def build_test_pairs(poses: np.ndarray, min_spacing: float = 10.0
                     ) -> List[Tuple[int, int]]:
    """Registration test pairs: frames whose relative translation is just above
    ``min_spacing`` meters (the MATLAB prep's 10 m pair spacing)."""
    t = poses[:, :3, 3]
    pairs = []
    j = 0
    for i in range(len(poses)):
        if j <= i:
            j = i + 1
        while j < len(poses) and np.linalg.norm(t[j] - t[i]) < min_spacing:
            j += 1
        if j < len(poses):
            pairs.append((i, j))
    return pairs


def rotm_to_quat(R: np.ndarray) -> np.ndarray:
    """3x3 rotation -> (w, x, y, z) quaternion."""
    w = np.sqrt(max(0.0, 1 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
    if w > 1e-8:
        x = (R[2, 1] - R[1, 2]) / (4 * w)
        y = (R[0, 2] - R[2, 0]) / (4 * w)
        z = (R[1, 0] - R[0, 1]) / (4 * w)
    else:
        # fall back to the largest diagonal term
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(0.0, 1 + R[i, i] - R[j, j] - R[k, k])) * 2
        q = np.zeros(4)
        q[1 + i] = s / 4
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
        return q
    return np.array([w, x, y, z])


def write_groundtruths_txt(path: str, poses: np.ndarray,
                           pairs: List[Tuple[int, int]]) -> None:
    """Write the groundtruths.txt format the eval loaders parse: header +
    ``anc pos tx ty tz qw qx qy qz`` with T mapping pos into the anc frame."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("anc pos tx ty tz qw qx qy qz\n")
        for a, p in pairs:
            rel = np.linalg.inv(poses[a]) @ poses[p]
            q = rotm_to_quat(rel[:3, :3])
            t = rel[:3, 3]
            f.write(f"{a} {p} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                    f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")


def build_modelnet_rotated(src_files, out_root: str, seed: int = 0) -> int:
    """Build the rotated-ModelNet repeatability set consumed by
    ModelNetRotatedFrames: <out>/original/<i>.npy, <out>/rotated/<i>.npy and
    <out>/rotated/<i>_gt.npy (4x4 transform mapping rotated coords back into the
    original frame), from per-shape Nx6 (xyz+normal) arrays."""
    rng = np.random.default_rng(seed)
    orig_dir = os.path.join(out_root, "original")
    rot_dir = os.path.join(out_root, "rotated")
    os.makedirs(orig_dir, exist_ok=True)
    os.makedirs(rot_dir, exist_ok=True)
    for i, path in enumerate(src_files):
        data = np.load(path).astype(np.float32)
        np.save(os.path.join(orig_dir, f"{i}.npy"), data)
        angles = rng.uniform(0, 2 * np.pi, size=3)
        cx, sx = np.cos(angles[0]), np.sin(angles[0])
        cy, sy = np.cos(angles[1]), np.sin(angles[1])
        cz, sz = np.cos(angles[2]), np.sin(angles[2])
        Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        R = (Rz @ Ry @ Rx).astype(np.float32)
        rotated = data.copy()
        rotated[:, :3] = data[:, :3] @ R.T
        if data.shape[1] >= 6:
            rotated[:, 3:6] = data[:, 3:6] @ R.T
        np.save(os.path.join(rot_dir, f"{i}.npy"), rotated)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R.T  # maps rotated coords back into the original frame
        np.save(os.path.join(rot_dir, f"{i}_gt.npy"), T)
    return len(src_files)
