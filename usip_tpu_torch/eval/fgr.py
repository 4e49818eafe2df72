"""Fast Global Registration (Zhou, Park, Koltun, ECCV 2016) — native rebuild.

The reference ships FGR only as a prebuilt MATLAB mex baseline for the indoor
evaluation (evaluation/matlab/eval_indoor/fgr/fast_global_registration.cpp:77-83
drives CApp::{NormalizePoints,AdvancedMatching,OptimizePairwise};
register2FragmentsFGR.m:34 calls it on keypoints+descriptors). This module
re-implements the published algorithm in vectorized numpy so the indoor eval
can run the FGR estimator without MATLAB or the mex toolchain:

1. normalize both clouds (center, global scale),
2. descriptor correspondences: mutual (reciprocal) 1-NN + the random 3-tuple
   side-length-ratio consistency test,
3. graduated non-convexity over the scaled Geman-McClure objective: alternate
   closed-form line-process weights with one Gauss-Newton step on SE(3),
   annealing mu every 4 iterations (div factor 1.4, 64 iterations — the
   published defaults compiled into the mex).

Keypoint sets here are small (hundreds of rows), so this is a host-side
numpy path by design — the same placement the reference gives it (eval-only,
never in the training hot loop).

The port's own copy of ``usip_tpu/eval/fgr.py``, held equal to it by
``tests/test_torch_host.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# Published FGR defaults (the constants compiled into the reference mex).
DIV_FACTOR = 1.4
MAX_CORR_DIST = 0.025
ITERATION_NUMBER = 64
TUPLE_SCALE = 0.95
TUPLE_MAX_COUNT = 1000


def _nn_indices(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Index of the nearest row of ``b`` for every row of ``a`` (euclidean)."""
    # (n, m) distance via the matmul identity; fine at keypoint scale
    d = (np.sum(a * a, 1)[:, None] + np.sum(b * b, 1)[None, :]
         - 2.0 * (a @ b.T))
    return np.argmin(d, axis=1)


def match_features(feat_src: np.ndarray, feat_dst: np.ndarray,
                   pts_src: np.ndarray, pts_dst: np.ndarray,
                   tuple_scale: float = TUPLE_SCALE,
                   tuple_max_count: int = TUPLE_MAX_COUNT,
                   rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """AdvancedMatching: reciprocal descriptor 1-NN + tuple test.

    Returns an (K, 2) int array of (src_idx, dst_idx) correspondences.
    """
    rng = rng or np.random.default_rng(0)
    fwd = _nn_indices(feat_src, feat_dst)            # src -> dst
    bwd = _nn_indices(feat_dst, feat_src)            # dst -> src
    src_idx = np.arange(len(feat_src))
    mutual = bwd[fwd] == src_idx
    corres = np.stack([src_idx[mutual], fwd[mutual]], axis=1)
    if len(corres) < 3:
        return corres

    # Tuple test: random triples must have consistent side-length ratios
    # between the two clouds (scale in [tuple_scale, 1/tuple_scale]).
    lo, hi = tuple_scale, 1.0 / tuple_scale
    tries = rng.integers(0, len(corres), size=(tuple_max_count, 3))
    keep = np.zeros(len(corres), dtype=bool)
    p = pts_src[corres[:, 0]]
    q = pts_dst[corres[:, 1]]
    i0, i1, i2 = tries[:, 0], tries[:, 1], tries[:, 2]

    def side(x, a, b):
        return np.linalg.norm(x[a] - x[b], axis=1)

    ok = np.ones(len(tries), dtype=bool)
    for a, b in ((i0, i1), (i1, i2), (i2, i0)):
        ds = side(p, a, b)
        dd = side(q, a, b)
        ratio = np.where(dd > 0, ds / np.maximum(dd, 1e-12), 0.0)
        ok &= (ratio > lo) & (ratio < hi)
    for col in (i0, i1, i2):
        keep[col[ok]] = True
    kept = corres[keep]
    return kept if len(kept) >= 3 else corres


def _exp_se3(xi: np.ndarray) -> np.ndarray:
    """SE(3) exponential of xi = [omega(3), t(3)] (small-angle-safe)."""
    omega, t = xi[:3], xi[3:]
    theta = np.linalg.norm(omega)
    K = np.array([[0, -omega[2], omega[1]],
                  [omega[2], 0, -omega[0]],
                  [-omega[1], omega[0], 0]])
    if theta < 1e-12:
        R = np.eye(3) + K
        V = np.eye(3) + 0.5 * K
    else:
        s, c = np.sin(theta), np.cos(theta)
        R = np.eye(3) + (s / theta) * K + ((1 - c) / theta ** 2) * (K @ K)
        V = (np.eye(3) + ((1 - c) / theta ** 2) * K
             + ((theta - s) / theta ** 3) * (K @ K))
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = V @ t
    return T


def optimize_pairwise(pts_src: np.ndarray, pts_dst: np.ndarray,
                      corres: np.ndarray, scale: float,
                      iterations: int = ITERATION_NUMBER) -> np.ndarray:
    """Graduated-non-convexity Gauss-Newton on the scaled Geman-McClure
    objective (CApp::OptimizePairwise). Points must be pre-normalized; returns
    T aligning src onto dst in the normalized frame."""
    if len(corres) < 3:
        return np.eye(4)
    p = pts_src[corres[:, 0]]
    q = pts_dst[corres[:, 1]]
    T = np.eye(4)
    mu = 1.0  # clouds are scale-normalized, so the GNC schedule starts at 1
    for it in range(iterations):
        if it > 0 and it % 4 == 0:
            mu = max(mu / DIV_FACTOR, MAX_CORR_DIST / scale)
        ps = p @ T[:3, :3].T + T[:3, 3]
        r = ps - q                                     # (K, 3)
        l = (mu / (mu + np.sum(r * r, axis=1))) ** 2   # line-process weights
        # Gauss-Newton step: residual d(ps)/d(xi) = [-[ps]x | I]
        J = np.zeros((len(ps), 3, 6))
        J[:, 0, 1] = ps[:, 2]
        J[:, 0, 2] = -ps[:, 1]
        J[:, 1, 0] = -ps[:, 2]
        J[:, 1, 2] = ps[:, 0]
        J[:, 2, 0] = ps[:, 1]
        J[:, 2, 1] = -ps[:, 0]
        J[:, :, 3:] = np.eye(3)
        w = l[:, None, None]
        JTJ = np.einsum("kic,kid->cd", J * w, J)
        JTr = np.einsum("kic,ki->c", J * w, r)
        try:
            xi = np.linalg.solve(JTJ + 1e-9 * np.eye(6), -JTr)
        except np.linalg.LinAlgError:
            break
        T = _exp_se3(xi) @ T
    return T


def fast_global_registration(pts_src: np.ndarray, feat_src: np.ndarray,
                             pts_dst: np.ndarray, feat_dst: np.ndarray,
                             iterations: int = ITERATION_NUMBER,
                             rng: Optional[np.random.Generator] = None,
                             ) -> Tuple[np.ndarray, int]:
    """Full FGR pipeline on keypoints+descriptors. Returns (T, num_corres)
    with T (4, 4) mapping ``pts_src`` onto ``pts_dst`` in the original frame —
    the mex's contract (fast_global_registration.cpp:77-90) with the cloud
    order made explicit."""
    pts_src = np.asarray(pts_src, np.float64)
    pts_dst = np.asarray(pts_dst, np.float64)
    mean_s = pts_src.mean(0)
    mean_d = pts_dst.mean(0)
    ps = pts_src - mean_s
    pd = pts_dst - mean_d
    scale = max(float(np.linalg.norm(ps, axis=1).max()),
                float(np.linalg.norm(pd, axis=1).max()), 1e-12)
    ps /= scale
    pd /= scale

    corres = match_features(np.asarray(feat_src, np.float64),
                            np.asarray(feat_dst, np.float64), ps, pd, rng=rng)
    Tn = optimize_pairwise(ps, pd, corres, scale, iterations)

    # Denormalize: x_dst = R x_src + t in the original frame.
    T = np.eye(4)
    T[:3, :3] = Tn[:3, :3]
    T[:3, 3] = scale * Tn[:3, 3] - Tn[:3, :3] @ mean_s + mean_d
    return T, len(corres)
