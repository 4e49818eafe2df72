"""Registration test pairs and their ground-truth table (counterpart of
``usip_tpu/data/preprocess.py:184-234``; the port keeps its own copy of what
the synthetic KITTI tree needs). The raw-scan preprocessing (voxel grid,
normals, the KITTI and rotated-ModelNet tree builders) is not ported.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np


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
