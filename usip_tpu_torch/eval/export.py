"""Keypoint export: NMS, sigma-ranking, count enforcement, .bin files
(counterpart of ``usip_tpu/eval/export.py``; the port keeps its own copy).

Python re-implementation of the reference export tool
(evaluation/save_keypoints.py:180-227,343-393): greedy NMS keeping the
smallest sigma first, top-K by sigma, pad-from-cloud, a float32 ``.bin`` per
frame (the reference's format, so keypoints stay interchangeable with its
MATLAB eval)."""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def nms(keypoints: np.ndarray, sigmas: np.ndarray,
        radius: float) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy sigma-ascending NMS (save_keypoints.py:180-216).

    Iteratively keeps the smallest-sigma keypoint and drops all others within
    ``radius``. radius < 0.01 disables (returns inputs unchanged).
    """
    if radius < 0.01:
        return keypoints, sigmas
    kept_kp = []
    kept_sig = []
    kp, sig = keypoints, sigmas
    while kp.shape[0] > 0:
        i = int(np.argmin(sig))
        kept_kp.append(kp[i])
        kept_sig.append(sig[i])
        d = np.linalg.norm(kp - kp[i], axis=1)
        mask = d > radius
        kp, sig = kp[mask], sig[mask]
    return np.stack(kept_kp), np.asarray(kept_sig)


def select_keypoint_indices(keypoints: np.ndarray, sigmas: np.ndarray, *,
                            nms_radius: float = 0.0,
                            desired_num: int = 128) -> np.ndarray:
    """Index-tracking form of NMS -> sigma-rank -> top-K: returns row indices
    into ``keypoints`` (length <= desired_num, no pad-from-cloud), so rows of
    a parallel array stay paired with their keypoints."""
    if nms_radius < 0.01:
        kept = np.arange(keypoints.shape[0])
    else:
        kept_list = []
        idx = np.arange(keypoints.shape[0])
        kp, sig = keypoints, sigmas
        while kp.shape[0] > 0:
            i = int(np.argmin(sig))
            kept_list.append(idx[i])
            mask = np.linalg.norm(kp - kp[i], axis=1) > nms_radius
            kp, sig, idx = kp[mask], sig[mask], idx[mask]
        kept = np.asarray(kept_list, dtype=np.int64)
    order = np.argsort(sigmas[kept])
    return kept[order][:desired_num]


def ensure_keypoint_number(keypoints: np.ndarray, pc: np.ndarray, num: int,
                           rng: Optional[np.random.Generator] = None
                           ) -> np.ndarray:
    """Pad (random cloud points) or subsample to exactly ``num`` keypoints
    (save_keypoints.py:219-227)."""
    rng = rng or np.random.default_rng()
    k = keypoints.shape[0]
    if k == num:
        return keypoints
    if k > num:
        return keypoints[rng.choice(k, num, replace=False)]
    extra = pc[rng.choice(pc.shape[0], num - k, replace=False)]
    return np.concatenate([keypoints, extra], axis=0)


def select_keypoints(keypoints: np.ndarray, sigmas: np.ndarray,
                     pc: np.ndarray, *, nms_radius: float = 0.0,
                     desired_num: int = 128,
                     rng: Optional[np.random.Generator] = None,
                     return_sigmas: bool = False):
    """Full export post-processing for one frame: NMS -> sort by sigma ->
    top-K -> ensure count (save_keypoints.py:343-351).

    With ``return_sigmas``, also returns the sigma of each *selected*
    keypoint (row i of the sigmas matches row i of the keypoints even when
    NMS dropped proposals); pad-from-cloud rows get sigma=inf.
    """
    kp, sig = nms(keypoints, sigmas, nms_radius)
    order = np.argsort(sig)
    kp, sig = kp[order][:desired_num], sig[order][:desired_num]
    if not return_sigmas:
        return ensure_keypoint_number(kp, pc, desired_num, rng)
    rng = rng or np.random.default_rng()
    k = kp.shape[0]  # <= desired_num: trimmed sigma-sorted above
    if k < desired_num:
        extra = pc[rng.choice(pc.shape[0], desired_num - k, replace=False)]
        kp = np.concatenate([kp, extra], axis=0)
        sig = np.concatenate([sig, np.full(desired_num - k, np.inf,
                                           sig.dtype)])
    return kp, sig


def write_keypoints_bin(path: str, keypoints: np.ndarray) -> None:
    """float32 row-major .bin, the reference's exchange format
    (save_keypoints.py:367-393)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    keypoints.astype(np.float32).tofile(path)


def read_keypoints_bin(path: str, dim: int = 3) -> np.ndarray:
    data = np.fromfile(path, dtype=np.float32)
    return data.reshape(-1, dim)
