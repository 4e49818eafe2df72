"""Descriptor-based registration eval (counterpart of
``usip_tpu/eval/registration.py``; the port keeps its own copy, held equal to
usip_tpu's by ``tests/test_torch_host.py``): 1-NN matching, a vectorized
RANSAC rigid fit, the RTE/RRE success protocol.

A Python replacement of the reference's MATLAB pipeline
(eval_outdoor/kitti/evaluate_kitti.m:52-131 + external/ransacfitRt.m): 1-NN
descriptor match, RANSAC with 3-point rigid hypotheses (inlier threshold 1.0 m),
least-squares refit on inliers, success = RTE <= 2 m and RRE <= 5 deg. The RANSAC
inner loop is vectorized over hypothesis batches instead of MATLAB's serial loop,
with the same adaptive 0.99-confidence stopping rule."""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np


def match_descriptors_1nn(anc_desc: np.ndarray, pos_desc: np.ndarray
                          ) -> np.ndarray:
    """For each anc descriptor its 1-NN in pos (evaluate_kitti.m:53-54).

    Returns (M, 2) index pairs [anc_idx, pos_idx].
    """
    d2 = (np.sum(anc_desc ** 2, 1)[:, None] + np.sum(pos_desc ** 2, 1)[None, :]
          - 2.0 * anc_desc @ pos_desc.T)
    nn = np.argmin(d2, axis=1)
    return np.stack([np.arange(anc_desc.shape[0]), nn], axis=1)


def kabsch(x1: np.ndarray, x2: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Least-squares rigid fit: R, t with x1 ~= R @ x2 + t. x1/x2: (..., N, 3)."""
    c1 = x1.mean(axis=-2, keepdims=True)
    c2 = x2.mean(axis=-2, keepdims=True)
    a = x1 - c1
    b = x2 - c2
    H = np.swapaxes(b, -1, -2) @ a            # (..., 3, 3), maps x2 -> x1
    U, _, Vt = np.linalg.svd(H)
    d = np.linalg.det(np.swapaxes(Vt, -1, -2) @ np.swapaxes(U, -1, -2))
    S = np.zeros_like(H)
    S[..., 0, 0] = 1.0
    S[..., 1, 1] = 1.0
    S[..., 2, 2] = d
    R = np.swapaxes(Vt, -1, -2) @ S @ np.swapaxes(U, -1, -2)
    t = (c1 - (R @ np.swapaxes(c2, -1, -2)).swapaxes(-1, -2)).squeeze(-2)
    return R, t


class RansacResult(NamedTuple):
    R: Optional[np.ndarray]       # (3, 3)
    t: Optional[np.ndarray]       # (3,)
    inliers: np.ndarray           # indices into the match list
    trials: int


def ransac_rigid(x1: np.ndarray, x2: np.ndarray, threshold: float = 1.0,
                 max_trials: int = 10000, confidence: float = 0.99,
                 batch: int = 256, seed: int = 0) -> RansacResult:
    """RANSAC rigid fit of matched points (x1 ~= R @ x2 + t), vectorized.

    Hypotheses are evaluated in batches on the host; stopping follows the standard
    adaptive rule trials >= log(1-conf)/log(1-inlier_frac^3) like ransac.m.
    """
    n = x1.shape[0]
    rng = np.random.default_rng(seed)
    if n < 3:
        return RansacResult(None, None, np.empty(0, np.int64), 0)
    if n == 3:
        R, t = kabsch(x1, x2)
        return RansacResult(R, t, np.arange(3), 0)

    best_count = -1
    best_inliers = np.empty(0, np.int64)
    trials_needed = max_trials
    done = 0
    while done < min(trials_needed, max_trials):
        k = min(batch, max_trials - done)
        idx = rng.integers(0, n, size=(k, 3))
        # drop degenerate (repeated-point) samples
        ok = ((idx[:, 0] != idx[:, 1]) & (idx[:, 0] != idx[:, 2])
              & (idx[:, 1] != idx[:, 2]))
        idx = idx[ok]
        if idx.shape[0] == 0:
            done += k
            continue
        R, t = kabsch(x1[idx], x2[idx])               # (k, 3, 3), (k, 3)
        pred = np.einsum("kij,nj->kni", R, x2) + t[:, None, :]
        d = np.linalg.norm(x1[None] - pred, axis=-1)  # (k, n)
        counts = (d < threshold).sum(axis=1)
        j = int(np.argmax(counts))
        if counts[j] > best_count:
            best_count = int(counts[j])
            best_inliers = np.nonzero(d[j] < threshold)[0]
            frac = max(best_count / n, 1e-8)
            p_good = min(max(frac ** 3, 1e-12), 1 - 1e-12)
            trials_needed = int(np.ceil(np.log(1 - confidence)
                                        / np.log(1 - p_good)))
        done += k
    if best_inliers.size >= 3:
        R, t = kabsch(x1[best_inliers], x2[best_inliers])
        return RansacResult(R, t, best_inliers, done)
    return RansacResult(None, None, best_inliers, done)


def transform_error(T_gt: np.ndarray, R: np.ndarray, t: np.ndarray
                    ) -> Tuple[float, float]:
    """(RTE meters, RRE degrees) — compareTransform (eval_outdoor/Utils.m:320-325):
    translation norm difference and the sum of absolute Euler angles of
    R_gt^T @ R_est."""
    rte = float(np.linalg.norm(T_gt[:3, 3] - t))
    dR = T_gt[:3, :3].T @ R
    # ZYX euler like MATLAB rotm2eul default
    sy = -dR[2, 0]
    sy = np.clip(sy, -1.0, 1.0)
    pitch = np.arcsin(sy)
    if abs(sy) < 1.0 - 1e-9:
        roll = np.arctan2(dR[2, 1], dR[2, 2])
        yaw = np.arctan2(dR[1, 0], dR[0, 0])
    else:
        roll = np.arctan2(-dR[1, 2], dR[1, 1])
        yaw = 0.0
    rre = float((abs(yaw) + abs(pitch) + abs(roll)) * 180.0 / np.pi)
    return rte, rre


class RegistrationStats(NamedTuple):
    success_rate: float
    failures: int
    total: int
    rte_mean: float
    rte_std: float
    rre_mean: float
    rre_std: float
    inlier_ratio_mean: float
    trials_mean: float


def evaluate_registration(pairs, threshold: float = 1.0, max_trials: int = 10000,
                          rte_limit: float = 2.0, rre_limit: float = 5.0,
                          seed: int = 0) -> RegistrationStats:
    """Full protocol over (anc_kp, anc_desc, pos_kp, pos_desc, T_gt) tuples.

    T_gt maps pos coordinates into the anc frame. Success = RTE <= rte_limit and
    RRE <= rre_limit; RTE/RRE stats are over successful pairs only
    (evaluate_kitti.m:104-131)."""
    failures = 0
    total = 0
    rtes, rres, ratios, trials = [], [], [], []
    for i, (anc_kp, anc_desc, pos_kp, pos_desc, T_gt) in enumerate(pairs):
        total += 1
        matches = match_descriptors_1nn(anc_desc, pos_desc)
        x1 = anc_kp[matches[:, 0]]
        x2 = pos_kp[matches[:, 1]]
        res = ransac_rigid(x1, x2, threshold, max_trials, seed=seed + i)
        if res.R is None:
            failures += 1
            continue
        rte, rre = transform_error(T_gt, res.R, res.t)
        if rte > rte_limit or rre > rre_limit:
            failures += 1
            continue
        rtes.append(rte)
        rres.append(rre)
        ratios.append(res.inliers.size / matches.shape[0])
        trials.append(res.trials)
    # total counted inside the loop so generator inputs work (a post-loop
    # len(list(pairs)) would see an exhausted iterator -> total=0)
    n_ok = len(rtes)
    return RegistrationStats(
        success_rate=n_ok / max(total, 1),
        failures=failures,
        total=total,
        rte_mean=float(np.mean(rtes)) if rtes else float("nan"),
        rte_std=float(np.std(rtes)) if rtes else float("nan"),
        rre_mean=float(np.mean(rres)) if rres else float("nan"),
        rre_std=float(np.std(rres)) if rres else float("nan"),
        inlier_ratio_mean=float(np.mean(ratios)) if ratios else float("nan"),
        trials_mean=float(np.mean(trials)) if trials else float("nan"),
    )
