"""Keypoint repeatability (counterpart of ``usip_tpu/eval/repeatability.py``;
the port keeps its own copy): the reference's north-star metric, transcribed
from MATLAB (evaluation/matlab/eval_repeatability/eval_rep.m:142-153).

For a GT-registered pair: transform the pos keypoints into the anc frame, find the
nearest anc keypoint of each transformed pos keypoint, and report the fraction
closer than ``inlier_radius`` (0.5 m outdoor default, eval_rep.m:7)."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def apply_transform(points: np.ndarray, T: np.ndarray) -> np.ndarray:
    """Apply a 3x4 or 4x4 rigid transform to (N, 3) points."""
    R, t = T[:3, :3], T[:3, 3]
    return points @ R.T + t


def pair_repeatability(anc_keypoints: np.ndarray, pos_keypoints: np.ndarray,
                       T_gt: np.ndarray, inlier_radius: float = 0.5) -> float:
    """Repeatability of one pair: #(NN dist < radius) / #anc keypoints.

    ``T_gt`` maps pos coordinates into the anc frame (eval_rep.m:142-146; the
    denominator is the anc keypoint count and the NN search is pos->anc).
    """
    pos_t = apply_transform(pos_keypoints, T_gt)
    d2 = ((pos_t[:, None, :] - anc_keypoints[None, :, :]) ** 2).sum(-1)
    nn = np.sqrt(d2.min(axis=1))
    return float((nn < inlier_radius).sum() / anc_keypoints.shape[0])


def dataset_repeatability(pairs: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
                          inlier_radius: float = 0.5) -> Tuple[float, np.ndarray]:
    """Mean repeatability over (anc_kp, pos_kp, T_gt) pairs."""
    arr = np.asarray([pair_repeatability(a, p, T, inlier_radius)
                      for a, p, T in pairs])
    return float(arr.mean()), arr
