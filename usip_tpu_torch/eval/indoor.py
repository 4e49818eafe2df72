"""Indoor (3DMatch / Redwood) fragment-registration evaluation.

Python replacement of the reference's MATLAB ElasticReconstruction pipeline
(evaluation/matlab/eval_indoor/):

* fragment pair registration — kNN descriptor matching (k=5, union of both
  directions) + RANSAC rigid fit with 0.2 m inliers, surface-overlap ratio and
  the 6x6 information matrix of inlier keypoints
  (3dmatch/register2Fragments.m:15-160, clusterCallback.m:10-35),
* scene .log assembly with the overlap/inlier gates
  (3dmatch/writeLog.m:47-60: alignRatio > 0.23 and inlierRatio > 0.025),
* registration recall/precision per Choi et al. 2015 — non-adjacent pairs only,
  error p = e' * info * e / info[0,0] with e = [t; -q_xyz] of gt^-1 @ result,
  good if p <= 0.04 (external/ElasticReconstruction/mrEvaluateRegistrationMy.m),
* the Redwood loop evaluation — the same recall/precision over externally
  produced reconstruction logs (loop_evaluation/eval_loop.m).

File formats are kept text-compatible with the reference artifacts (gt.log /
gt.info / <scene>.log as read by mrLoadLog/mrLoadInfo/mrLoadLogMy), so logs and
ground truth move freely between the two implementations.

"Lite" evaluation per fullEvaluation.m:1-12: RANSAC capped at 1000 iterations;
overlapped pairs only (the gt.log provides exactly those).

The port's own copy of ``usip_tpu/eval/indoor.py``, held equal to it by
``tests/test_torch_host.py``: host numpy, on the registration helpers of
``usip_tpu_torch/eval/registration.py``.
"""

from __future__ import annotations

import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from usip_tpu_torch.eval.registration import kabsch, ransac_rigid


# ---------------------------------------------------------------- file IO ---


class LogEntry(NamedTuple):
    """One trajectory entry: fragment pair (i, j) of a scene with n fragments
    and the 4x4 transform aligning fragment j into fragment i's frame."""

    i: int
    j: int
    n: int
    trans: np.ndarray                       # (4, 4)
    # extras present in the 'My' result logs (mrLoadLogMy.m)
    num_inliers: Optional[int] = None
    inlier_ratio: Optional[float] = None
    information: Optional[np.ndarray] = None  # (6, 6)


def load_log(path: str) -> List[LogEntry]:
    """Choi et al. .log: header 'i j n' + 4x4 transform (mrLoadLog.m)."""
    vals = _read_tokens(path)
    entries, p = [], 0
    while p + 19 <= len(vals):
        i, j, n = int(vals[p]), int(vals[p + 1]), int(vals[p + 2])
        trans = np.asarray(vals[p + 3:p + 19], np.float64).reshape(4, 4)
        entries.append(LogEntry(i, j, n, trans))
        p += 19
    return entries


def load_info(path: str) -> List[LogEntry]:
    """gt.info: header 'i j n' + 6x6 information matrix (mrLoadInfo.m)."""
    vals = _read_tokens(path)
    entries, p = [], 0
    while p + 39 <= len(vals):
        i, j, n = int(vals[p]), int(vals[p + 1]), int(vals[p + 2])
        mat = np.asarray(vals[p + 3:p + 39], np.float64).reshape(6, 6)
        entries.append(LogEntry(i, j, n, trans=np.eye(4), information=mat))
        p += 39
    return entries


def load_log_my(path: str) -> List[LogEntry]:
    """Result log with inlier stats + information matrix (mrLoadLogMy.m):
    'i j n' + 4x4 + 'num_inliers inlier_ratio' + 6x6."""
    vals = _read_tokens(path)
    entries, p = [], 0
    while p + 57 <= len(vals):
        i, j, n = int(vals[p]), int(vals[p + 1]), int(vals[p + 2])
        trans = np.asarray(vals[p + 3:p + 19], np.float64).reshape(4, 4)
        num_inliers = int(vals[p + 19])
        inlier_ratio = float(vals[p + 20])
        info = np.asarray(vals[p + 21:p + 57], np.float64).reshape(6, 6)
        entries.append(LogEntry(i, j, n, trans, num_inliers, inlier_ratio, info))
        p += 57
    return entries


def write_log_my(path: str, entries: Sequence[LogEntry]) -> None:
    """Write the result log in the reference's format (writeLog.m:55-59)."""
    with open(path, "w") as f:
        for e in entries:
            f.write(f"{e.i}\t {e.j}\t {e.n}\t\n")
            for row in np.asarray(e.trans):
                f.write("\t".join(f"{v:.10f}" for v in row) + "\n")
            f.write(f"{e.num_inliers}\t{e.inlier_ratio:f}\n")
            info = e.information if e.information is not None else np.zeros((6, 6))
            for row in np.asarray(info):
                f.write("\t".join(f"{v:.10f}" for v in row) + "\n")


def load_result_log(path: str) -> List[LogEntry]:
    """Load a result log of either format (plain mrLoadLog or mrLoadLogMy).

    The formats are token-ambiguous (3 plain entries = 57 tokens = 1 'My'
    entry), so both parses are validated structurally — integral headers with
    i < j, homogeneous bottom row [0 0 0 1] — and the parse explaining more of
    the file wins."""
    n_tokens = len(_read_tokens(path))
    if n_tokens == 0:
        # zero proposed registrations is a legitimate outcome (every pair
        # gated out by writeLog.m:52-53) -> recall 0, not a parse error
        return []
    candidates = []
    for loader, stride in ((load_log, 19), (load_log_my, 57)):
        try:
            entries = loader(path)
        except (ValueError, IndexError):
            continue
        if entries and all(_entry_valid(e) for e in entries):
            exact = len(entries) * stride == n_tokens
            candidates.append((exact, len(entries), entries))
    if not candidates:
        raise ValueError(f"{path}: not a recognizable registration log")
    return max(candidates, key=lambda c: (c[0], c[1]))[2]


def _entry_valid(e: LogEntry) -> bool:
    if not (0 <= e.i < e.j < e.n):
        return False
    if not np.allclose(e.trans[3], [0, 0, 0, 1], atol=1e-6):
        return False
    if e.inlier_ratio is not None and not (0.0 <= e.inlier_ratio <= 1.0):
        return False
    return True


def _read_tokens(path: str) -> List[float]:
    toks: List[float] = []
    with open(path) as f:
        for line in f:
            toks.extend(float(t) for t in line.split())
    return toks


def load_fragment_features(path: str, feature_dim: int = 128
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Keypoint+descriptor .bin: float32 rows of [x y z d_0..d_{D-1}]
    (register2Fragments.m:23-30 via Utils.load_descriptors)."""
    flat = np.fromfile(path, np.float32)
    rows = flat.reshape(-1, 3 + feature_dim)
    return rows[:, :3].astype(np.float64), rows[:, 3:].astype(np.float64)


# --------------------------------------------------- pairwise registration ---


def knn_union_matches(desc1: np.ndarray, desc2: np.ndarray, k: int = 5
                      ) -> np.ndarray:
    """kNN matching in both directions, union of index pairs
    (register2Fragments.m:44-59). Returns (M, 2) [idx1, idx2]."""
    d2 = (np.sum(desc1 ** 2, 1)[:, None] + np.sum(desc2 ** 2, 1)[None, :]
          - 2.0 * desc1 @ desc2.T)
    k12 = min(k, desc2.shape[0])
    k21 = min(k, desc1.shape[0])
    nn12 = np.argsort(d2, axis=1)[:, :k12]                 # (N1, k)
    nn21 = np.argsort(d2, axis=0)[:k21, :].T               # (N2, k)
    m12 = np.stack([np.repeat(np.arange(desc1.shape[0]), k12),
                    nn12.reshape(-1)], axis=1)
    m21 = np.stack([nn21.reshape(-1),
                    np.repeat(np.arange(desc2.shape[0]), k21)], axis=1)
    return np.unique(np.concatenate([m12, m21], axis=0), axis=0)


def information_matrix(points: np.ndarray) -> np.ndarray:
    """Sum of A'A over keypoints (register2Fragments.m:78-91); the standard
    point-to-point registration information used by the Choi et al. error."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    zeros = np.zeros_like(x)
    ones = np.ones_like(x)
    # rows of A per point, shape (N, 3, 6)
    A = np.stack([
        np.stack([ones, zeros, zeros, zeros, 2 * z, -2 * y], axis=1),
        np.stack([zeros, ones, zeros, -2 * z, zeros, 2 * x], axis=1),
        np.stack([zeros, zeros, ones, 2 * y, -2 * x, zeros], axis=1),
    ], axis=1)
    return np.einsum("nij,nik->jk", A, A)


class FragmentRegistration(NamedTuple):
    trans: np.ndarray          # (4, 4) aligning fragment 2 into fragment 1
    num_inliers: int
    inlier_ratio: float
    ratio_aligned: Tuple[float, float]
    information: np.ndarray    # (6, 6)


def register_fragments(pc1: np.ndarray, pc2: np.ndarray,
                       kp1: np.ndarray, desc1: np.ndarray,
                       kp2: np.ndarray, desc2: np.ndarray,
                       inlier_threshold: float = 0.2,
                       max_trials: int = 1000,
                       overlap_radius: float = 0.2,
                       knn_k: int = 5, seed: int = 0,
                       estimator: str = "ransac") -> FragmentRegistration:
    """Register fragment 2 onto fragment 1 (register2Fragments.m).

    'Lite' protocol: RANSAC capped at max_trials=1000 (fullEvaluation.m:5).
    ``estimator='fgr'`` swaps in Fast Global Registration — the reference's
    alternative estimator (register2FragmentsFGR.m:34, mex rebuilt natively in
    eval/fgr.py) — with inliers counted over mutual matches post-hoc.
    """
    matches = knn_union_matches(desc1, desc2, k=knn_k)
    x1 = kp1[matches[:, 0]]
    x2 = kp2[matches[:, 1]]
    if estimator == "fgr":
        from usip_tpu_torch.eval.fgr import fast_global_registration
        trans, _ = fast_global_registration(
            kp2, desc2, kp1, desc1, rng=np.random.default_rng(seed))
        x2_t = x2 @ trans[:3, :3].T + trans[:3, 3]
        inliers = np.flatnonzero(
            np.linalg.norm(x2_t - x1, axis=1) < inlier_threshold)
    elif estimator == "ransac":
        res = ransac_rigid(x1, x2, threshold=inlier_threshold,
                           max_trials=max_trials, seed=seed)
        if res.R is None:
            trans = np.eye(4)
            inliers = np.empty(0, np.int64)
        else:
            trans = np.eye(4)
            trans[:3, :3] = res.R
            trans[:3, 3] = res.t
            inliers = res.inliers
    else:
        raise ValueError(f"unknown estimator {estimator!r} (ransac|fgr)")
    info = information_matrix(kp1[matches[inliers, 0]]) if inliers.size \
        else np.zeros((6, 6))
    # surface overlap of the aligned clouds, both directions
    p2_t = pc2[:, :3] @ trans[:3, :3].T + trans[:3, 3]
    ra1 = _nn_within(pc1[:, :3], p2_t, overlap_radius)
    ra2 = _nn_within(p2_t, pc1[:, :3], overlap_radius)
    return FragmentRegistration(
        trans=trans, num_inliers=int(inliers.size),
        inlier_ratio=float(inliers.size / max(matches.shape[0], 1)),
        ratio_aligned=(ra1, ra2), information=info)


def _nn_within(query: np.ndarray, ref: np.ndarray, radius: float) -> float:
    """Fraction of query points whose NN in ref is closer than radius.

    cKDTree instead of blocked dense distances: full-resolution 3DMatch
    fragments run to 10^5+ points, where a (2048, N) float64 block is
    gigabyte-scale per pair."""
    from scipy.spatial import cKDTree

    if ref.shape[0] == 0 or query.shape[0] == 0:
        return 0.0
    d, _ = cKDTree(ref).query(query, k=1, distance_upper_bound=radius)
    return float(np.count_nonzero(np.isfinite(d) & (d < radius))
                 / max(query.shape[0], 1))


# ---------------------------------------------------- scene-level pipeline ---


def run_scene_registration(fragments: Sequence[Tuple[np.ndarray, np.ndarray,
                                                     np.ndarray]],
                           pairs: Optional[Sequence[Tuple[int, int]]] = None,
                           align_gate: float = 0.23,
                           inlier_gate: float = 0.025,
                           max_trials: int = 1000,
                           seed: int = 0,
                           estimator: str = "ransac") -> List[LogEntry]:
    """Register fragment pairs of one scene and gate them into a result log.

    Args:
      fragments: per fragment (pc (N,>=3), keypoints (M,3), descriptors (M,D)).
      pairs: (i, j) pairs to register; default all i<j (runFragmentRegistration
        .m:24-35). Passing the gt pairs gives the 'overlapped pairs only' lite
        protocol (fullEvaluation.m:6).
      align_gate/inlier_gate: writeLog.m:52-53 thresholds.
    """
    n = len(fragments)
    if pairs is None:
        pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    entries = []
    for idx, (i, j) in enumerate(pairs):
        pc1, kp1, d1 = fragments[i]
        pc2, kp2, d2 = fragments[j]
        reg = register_fragments(pc1, pc2, kp1, d1, kp2, d2,
                                 max_trials=max_trials, seed=seed + idx,
                                 estimator=estimator)
        if reg.ratio_aligned[0] > align_gate and reg.inlier_ratio > inlier_gate:
            entries.append(LogEntry(i, j, n, reg.trans, reg.num_inliers,
                                    reg.inlier_ratio, reg.information))
    return entries


# ------------------------------------------------------- recall/precision ---


def _dcm2quat(R: np.ndarray) -> np.ndarray:
    """Quaternion (w, x, y, z) per the Aerospace-Toolbox convention used by
    mrEvaluateRegistration.m."""
    w = 0.5 * np.sqrt(max(1.0 + R[0, 0] + R[1, 1] + R[2, 2], 1e-12))
    return np.array([
        w,
        -(R[2, 1] - R[1, 2]) / (4 * w),
        -(R[0, 2] - R[2, 0]) / (4 * w),
        -(R[1, 0] - R[0, 1]) / (4 * w),
    ])


def transformation_error(delta: np.ndarray, info: np.ndarray) -> float:
    """p = e' @ info @ e / info[0,0] with e = [t; -q_xyz] of the 4x4 delta
    (mrComputeTransformationError)."""
    te = delta[:3, 3]
    q = _dcm2quat(delta[:3, :3])
    e = np.concatenate([te, -q[1:4]])
    return float(e @ info @ e / info[0, 0])


class IndoorEvalResult(NamedTuple):
    recall: float
    precision: float
    good: int
    gt_num: int
    rs_num: int
    false_positives: int
    inlier_num_mean: float
    inlier_ratio_mean: float


def evaluate_scene(result: Sequence[LogEntry], gt: Sequence[LogEntry],
                   gt_info: Sequence[LogEntry],
                   err2: float = 0.04) -> IndoorEvalResult:
    """Registration recall/precision over non-adjacent pairs
    (mrEvaluateRegistrationMy.m): recall = good/gt_num, precision = good/rs_num;
    good if the information-weighted pose error p <= err2 (= 0.2^2 m^2 RMSE)."""
    gt_map: Dict[Tuple[int, int], int] = {}
    gt_num = 0
    for idx, e in enumerate(gt):
        if e.j - e.i > 1:
            gt_map[(e.i, e.j)] = idx
            gt_num += 1
    rs_num = good = false_pos = 0
    inlier_nums, inlier_ratios = [], []
    for e in result:
        if e.j - e.i <= 1:
            continue
        rs_num += 1
        idx = gt_map.get((e.i, e.j))
        if idx is None:
            false_pos += 1
            continue
        delta = np.linalg.inv(gt[idx].trans) @ e.trans
        p = transformation_error(delta, gt_info[idx].information)
        if p <= err2:
            good += 1
            if e.num_inliers is not None:
                inlier_nums.append(e.num_inliers)
            if e.inlier_ratio is not None:
                inlier_ratios.append(e.inlier_ratio)
    return IndoorEvalResult(
        recall=good / max(gt_num, 1),
        precision=good / max(rs_num, 1),
        good=good, gt_num=gt_num, rs_num=rs_num, false_positives=false_pos,
        inlier_num_mean=float(np.mean(inlier_nums)) if inlier_nums else float("nan"),
        inlier_ratio_mean=(float(np.mean(inlier_ratios))
                           if inlier_ratios else float("nan")),
    )


REDWOOD_SCENES = ("livingroom1", "livingroom2", "office1", "office2")


def evaluate_scenes(result_logs: Dict[str, str], gt_root: str,
                    err2: float = 0.04) -> Dict[str, IndoorEvalResult]:
    """Evaluate one result log per scene against <gt_root>/<scene>-evaluation/
    gt.log + gt.info (eval_loop.m / 3dmatch/evaluate.m layout). Result logs may
    be either plain (4x4 only) or 'My' (with inlier stats) format."""
    out = {}
    for scene, log_path in result_logs.items():
        gt_dir = os.path.join(gt_root, f"{scene}-evaluation")
        gt = load_log(os.path.join(gt_dir, "gt.log"))
        gt_info = load_info(os.path.join(gt_dir, "gt.info"))
        result = load_result_log(log_path)
        out[scene] = evaluate_scene(result, gt, gt_info, err2=err2)
    return out


def summarize(per_scene: Dict[str, IndoorEvalResult]) -> Dict[str, float]:
    """Mean recall/precision across scenes (evaluate.m:42-43)."""
    rs = [r.recall for r in per_scene.values()]
    ps = [r.precision for r in per_scene.values()]
    return {"mean_recall": float(np.mean(rs)) if rs else float("nan"),
            "mean_precision": float(np.mean(ps)) if ps else float("nan")}
