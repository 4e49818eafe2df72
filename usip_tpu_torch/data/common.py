"""Host-side data utilities of the port (counterpart of
``usip_tpu/data/common.py``; the port keeps its own copy of what it uses)."""

from __future__ import annotations

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
