"""Dataset preprocessing (counterpart of ``usip_tpu/data/preprocess.py``;
the port keeps its own copy of what its trees need): the voxel grid and PCA
surface normals (``:19-58``), the registration test pairs and their
ground-truth table (``:122-172``, the synthetic KITTI tree), and the
rotated-ModelNet repeatability tree (``build_modelnet_rotated``,
``:175-204``).
The raw KITTI scan preparation (``prepare_lidar_scan``,
``build_kitti_numpy_tree``) is not ported: every tree the port builds is
synthetic.
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
