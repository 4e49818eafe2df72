"""Classical keypoint baselines (counterpart of ``usip_tpu/eval/baselines.py``;
the port keeps its own copy): 'random', ISS (Intrinsic Shape Signatures), a
Harris-3D response detector and SIFT-3D (a PCL-style DoG scale pyramid over
the z field, the SIFTKeypointFieldSelector<PointXYZ> convention), the
detectors the repeatability protocol scores USIP against
(evaluation/save_keypoints.py:44-63,289-325). Host numpy/scipy code: the
same clouds give usip_tpu's keypoints bit for bit."""

from __future__ import annotations

from typing import Optional

import numpy as np
from scipy.spatial import cKDTree


def random_keypoints(rng: np.random.Generator, pc: np.ndarray,
                     num: int) -> np.ndarray:
    """Uniform random subset of the cloud (the 'random' method)."""
    idx = rng.choice(pc.shape[0], min(num, pc.shape[0]), replace=False)
    return pc[idx]


def _neighbor_lists(pc: np.ndarray, radius: float):
    tree = cKDTree(pc)
    return tree, tree.query_ball_point(pc, r=radius)


def iss_keypoints(pc: np.ndarray, salient_radius: float = 2.0,
                  non_max_radius: float = 2.0, gamma_21: float = 0.975,
                  gamma_32: float = 0.975, min_neighbors: int = 5,
                  max_keypoints: Optional[int] = None) -> np.ndarray:
    """ISS detector (Zhong 2009), matching PCL's ISSKeypoint3D semantics that the
    reference invokes (save_keypoints.py:291-301).

    Weighted scatter matrix per point (weights 1/|neighborhood|), eigenvalues
    l1 >= l2 >= l3; keypoint iff l2/l1 < gamma_21 and l3/l2 < gamma_32; saliency
    l3; non-max suppression within non_max_radius.
    """
    n = pc.shape[0]
    tree, neighborhoods = _neighbor_lists(pc, salient_radius)
    # per-point weights = 1 / neighbor count
    counts = np.asarray([len(nb) for nb in neighborhoods], np.float64)
    weights = 1.0 / np.maximum(counts, 1.0)

    saliency = np.full(n, -np.inf)
    for i in range(n):
        nb = neighborhoods[i]
        if len(nb) < min_neighbors:
            continue
        nb = np.asarray(nb)
        diff = pc[nb] - pc[i]
        w = weights[nb][:, None]
        cov = (diff * w).T @ diff / np.sum(weights[nb])
        evals = np.linalg.eigvalsh(cov)[::-1]  # descending l1 >= l2 >= l3
        l1, l2, l3 = evals
        if l1 <= 0:
            continue
        if (l2 / l1) < gamma_21 and (l3 / max(l2, 1e-12)) < gamma_32:
            saliency[i] = l3
    candidates = np.nonzero(np.isfinite(saliency))[0]
    if candidates.size == 0:
        return np.empty((0, 3), pc.dtype)
    # non-max suppression: keep if strictly the max saliency in its radius
    keep = []
    cand_tree = cKDTree(pc[candidates])
    cand_sal = saliency[candidates]
    for ci, gi in enumerate(candidates):
        nb = cand_tree.query_ball_point(pc[gi], r=non_max_radius)
        if cand_sal[ci] >= cand_sal[nb].max():
            keep.append(gi)
    kp = pc[np.asarray(keep)]
    if max_keypoints is not None and kp.shape[0] > max_keypoints:
        order = np.argsort(-saliency[np.asarray(keep)])
        kp = kp[order[:max_keypoints]]
    return kp


def harris3d_keypoints(pc: np.ndarray, radius: float = 1.0,
                       nms_radius: Optional[float] = None, k: float = 0.04,
                       threshold: Optional[float] = None, min_neighbors: int = 5,
                       max_keypoints: Optional[int] = None) -> np.ndarray:
    """Harris-3D response R = det(C) - k * trace(C)^2 over the neighborhood
    covariance, NMS on local response maxima.

    ``threshold=None`` (default) keeps ranking purely relative — the absolute R
    value is scale-dependent (R < 0 everywhere on smooth surfaces at small
    radii), so a fixed cutoff is only meaningful if the caller knows the cloud
    scale."""
    n = pc.shape[0]
    nms_radius = nms_radius if nms_radius is not None else radius
    tree, neighborhoods = _neighbor_lists(pc, radius)
    response = np.full(n, -np.inf)
    for i in range(n):
        nb = neighborhoods[i]
        if len(nb) < min_neighbors:
            continue
        diff = pc[np.asarray(nb)] - pc[np.asarray(nb)].mean(0)
        cov = diff.T @ diff / len(nb)
        r = np.linalg.det(cov) - k * np.trace(cov) ** 2
        if threshold is None or r > threshold:
            response[i] = r
    candidates = np.nonzero(np.isfinite(response))[0]
    if candidates.size == 0:
        return np.empty((0, 3), pc.dtype)
    keep = []
    cand_tree = cKDTree(pc[candidates])
    cand_resp = response[candidates]
    for ci, gi in enumerate(candidates):
        nb = cand_tree.query_ball_point(pc[gi], r=nms_radius)
        if cand_resp[ci] >= cand_resp[nb].max():
            keep.append(gi)
    kp = pc[np.asarray(keep)]
    if max_keypoints is not None and kp.shape[0] > max_keypoints:
        order = np.argsort(-response[np.asarray(keep)])
        kp = kp[order[:max_keypoints]]
    return kp


def sift3d_keypoints(pc: np.ndarray, min_scale: float = 0.5,
                     n_octaves: int = 4, n_scales_per_octave: int = 8,
                     min_contrast: float = 0.005,
                     max_keypoints: Optional[int] = None) -> np.ndarray:
    """SIFT-3D keypoints in the PCL ``SIFTKeypoint`` style that the reference
    invokes (save_keypoints.py:318-322: min_scale, n_octaves,
    n_scales_per_octave, min_contrast).

    Scalar field = z (PCL's ``SIFTKeypointFieldSelector<PointXYZ>``). Per
    octave o the field is Gaussian-smoothed over neighborhoods at scales
    ``min_scale * 2^o * 2^(i/n_scales_per_octave)``; difference-of-Gaussians
    between adjacent scales; a point is a keypoint when its DoG value is a
    strict spatial+scale extremum over neighbors within its scale radius and
    ``|DoG| > min_contrast``.

    Performance caveat: the smoothing/extremum loops are per-point Python
    over every (octave, scale) level — fine for the eval-time cloud sizes the
    reference feeds PCL baselines on objects/indoor data (<= ~10k points),
    but O(hours) at 16k-point LiDAR scale. Subsample first (eval protocols
    rank a few hundred keypoints anyway) or prefer the vectorized ISS/Harris
    baselines at that scale.
    """
    pc = np.asarray(pc, np.float64)
    field = pc[:, 2]
    tree = cKDTree(pc)
    keypoints: list[np.ndarray] = []
    responses: list[float] = []

    for octave in range(n_octaves):
        base = min_scale * (2.0 ** octave)
        nr = n_scales_per_octave + 3
        sigmas = [base * (2.0 ** (i / n_scales_per_octave)) for i in range(nr)]
        smoothed = []
        for sig in sigmas:
            # Gaussian smoothing over the 3*sigma neighborhood
            pairs = tree.query_ball_point(pc, r=3.0 * sig)
            sm = np.empty(len(pc))
            for i, nb in enumerate(pairs):
                nb = np.asarray(nb)
                d2 = np.sum((pc[nb] - pc[i]) ** 2, axis=1)
                w = np.exp(-d2 / (2.0 * sig * sig))
                sm[i] = float(np.sum(w * field[nb]) / np.sum(w))
            smoothed.append(sm)
        dog = [smoothed[i + 1] - smoothed[i] for i in range(nr - 1)]

        for s in range(1, len(dog) - 1):
            radius = sigmas[s]
            nbhd = tree.query_ball_point(pc, r=radius)
            vals = dog[s]
            for i, nb in enumerate(nbhd):
                v = vals[i]
                if abs(v) < min_contrast:
                    continue
                nb = np.asarray(nb)
                others = np.concatenate([
                    dog[s][nb[nb != i]], dog[s - 1][nb], dog[s + 1][nb]])
                if others.size == 0:
                    continue
                if v > others.max() or v < others.min():
                    keypoints.append(pc[i])
                    responses.append(abs(v))

    if not keypoints:
        return np.empty((0, 3), pc.dtype)
    kp = np.unique(np.asarray(keypoints), axis=0)
    if max_keypoints is not None and kp.shape[0] > max_keypoints:
        # rank duplicates-removed keypoints by their best response
        resp = {}
        for p, r in zip(keypoints, responses):
            key = tuple(p)
            resp[key] = max(resp.get(key, 0.0), r)
        order = np.argsort([-resp[tuple(p)] for p in kp])
        kp = kp[order[:max_keypoints]]
    return kp


# Above this size, sift3d's per-point Python loops take hours per cloud
# (see its docstring); the export dispatch subsamples first. Eval protocols
# only rank a few hundred keypoints, so the subsample is benign.
SIFT_MAX_POINTS = 8192


def baseline_keypoints(method: str, pc: np.ndarray,
                       rng: Optional[np.random.Generator] = None,
                       **kwargs) -> np.ndarray:
    """Dispatch like the reference export tool's method switch
    (save_keypoints.py:289-325).

    For ``sift`` on clouds larger than ``sift_max_points`` (default
    SIFT_MAX_POINTS), the cloud is randomly subsampled first — with a loud
    warning — so the default LiDAR presets (16k points) don't silently hang
    for hours in the per-point smoothing loops. Pass
    ``sift_max_points=None`` to force the full cloud.
    """
    if method == "random":
        return random_keypoints(rng or np.random.default_rng(), pc,
                                kwargs.get("num", 128))
    if method == "iss":
        return iss_keypoints(pc, **kwargs)
    if method == "harris":
        return harris3d_keypoints(pc, **kwargs)
    if method == "sift":
        max_pts = kwargs.pop("sift_max_points", SIFT_MAX_POINTS)
        if max_pts is not None and pc.shape[0] > max_pts:
            import logging
            logging.getLogger(__name__).warning(
                "sift baseline: subsampling %d -> %d points (per-point "
                "smoothing loops are O(hours) at this scale; pass "
                "sift_max_points=None to force the full cloud)",
                pc.shape[0], max_pts)
            sel = (rng or np.random.default_rng(0)).choice(
                pc.shape[0], max_pts, replace=False)
            pc = pc[np.sort(sel)]
        return sift3d_keypoints(pc, **kwargs)
    raise KeyError(f"unknown baseline method {method!r}")
