"""Host-side data utilities of the port (counterpart of
``usip_tpu/data/common.py``; the port keeps its own copy): fixed-size
subsampling, the channel split, the radius crop and the pose distance."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def subsample_fixed(rng: np.random.Generator, data: np.ndarray,
                    n: int) -> np.ndarray:
    """Random subset of exactly n rows; pads by whole-array repetition when the
    cloud is short (the reference's fix_idx loop,
    kitti_detector_loader.py:126-133 / scenenn_detector_loader.py:76-83).
    Draws the same numbers from ``rng`` as usip_tpu's, so one seed gives one
    subset in both packages."""
    m = data.shape[0]
    if m >= n:
        idx = rng.choice(m, n, replace=False)
        return data[idx]
    fix = np.arange(m)
    while fix.shape[0] + m < n:
        fix = np.concatenate([fix, np.arange(m)])
    extra = rng.choice(m, n - fix.shape[0], replace=False)
    sel = np.concatenate([fix, extra])
    # the returned rows are in uniformly random order: slice-mode device
    # sampling takes prefix/suffix crops and relies on it
    rng.shuffle(sel)
    return data[sel]


def split_pc_sn(data: np.ndarray, sn_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """Split an Nx(3+F) array into xyz + the sn feature block.

    sn_len == 1 selects the last column (reflectance-only mode,
    kitti_detector_loader.py:135-139); otherwise columns [3, 3+sn_len).
    """
    pc = data[:, 0:3].astype(np.float32)
    if sn_len <= 0:
        sn = np.zeros((data.shape[0], 0), np.float32)
    elif sn_len == 1:
        sn = data[:, -1:].astype(np.float32)
    else:
        sn = data[:, 3:3 + sn_len].astype(np.float32)
    return pc, sn


def radius_crop(data: np.ndarray, radius: float) -> np.ndarray:
    """Keep points with xz-plane norm <= radius (camera coords,
    kitti_detector_loader.py:119-123)."""
    norm = np.linalg.norm(data[:, [0, 2]], axis=1)
    return data[norm <= radius]


def relative_translation_norm(pose_a: np.ndarray, pose_b: np.ndarray) -> float:
    """||inv(A) @ B translation|| — pose distance for positive/negative mining."""
    rel = np.linalg.inv(pose_a) @ pose_b
    return float(np.linalg.norm(rel[0:3, 3]))
