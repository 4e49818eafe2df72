"""Classical keypoint baselines (counterpart of ``usip_tpu/eval/baselines.py``;
the port keeps its own copy of the ``random`` method, the repeatability
floor the quality gate divides by). ISS, Harris and SIFT are not ported."""

from __future__ import annotations

import numpy as np


def random_keypoints(rng: np.random.Generator, pc: np.ndarray,
                     num: int) -> np.ndarray:
    """Uniform random subset of the cloud (the 'random' method)."""
    idx = rng.choice(pc.shape[0], min(num, pc.shape[0]), replace=False)
    return pc[idx]
