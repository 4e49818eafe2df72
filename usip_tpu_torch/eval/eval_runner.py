"""Metric runners over exported keypoint .bin trees (counterpart of
``usip_tpu/eval/eval_runner.py``; the port keeps its own copy): the Python
replacement of the MATLAB scripts eval_rep.m and evaluate_kitti.m, their
ground-truth tables and their coordinate-frame fixes. The indoor runner
(``eval/indoor.py``) is not ported yet."""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from usip_tpu_torch.eval.export import read_keypoints_bin
from usip_tpu_torch.eval.registration import evaluate_registration
from usip_tpu_torch.eval.repeatability import dataset_repeatability


def quat_to_rotm(q: np.ndarray) -> np.ndarray:
    """w-x-y-z quaternion -> 3x3 rotation (MATLAB quat2rotm convention,
    evaluate_kitti.m:89-91)."""
    w, x, y, z = q
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n == 0 else 2.0 / n
    return np.array([
        [1 - s * (y * y + z * z), s * (x * y - w * z), s * (x * z + w * y)],
        [s * (x * y + w * z), 1 - s * (x * x + z * z), s * (y * z - w * x)],
        [s * (x * z - w * y), s * (y * z + w * x), 1 - s * (x * x + y * y)],
    ])


# ------------------------------------------------ coordinate-frame fixes ---
# The export tool writes keypoints in the detector's (camera) frame; the GT
# tables live in the sensor frame (velodyne for KITTI, ENU for Oxford). The
# reference applies these conversions inside eval_rep.m; without them the
# Python eval could not consume reference-produced .bins (or reference GT
# against this repo's exports).


def read_kitti_calib(path: str) -> Dict[str, np.ndarray]:
    """KITTI odometry calib.txt -> {'P0'..'P3', 'Tr'} as 4x4 matrices
    (eval_outdoor/read_kitti_calib.m: 3x4 rows promoted with [0 0 0 1])."""
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 13:
                continue
            name = parts[0].rstrip(":")
            P = np.eye(4)
            P[:3, :] = np.asarray(list(map(float, parts[1:])),
                                  np.float64).reshape(3, 4)
            out[name] = P
    return out


def cam_to_velodyne(points: np.ndarray, Tr: np.ndarray) -> np.ndarray:
    """Camera -> velodyne frame via the calib 'Tr' (velodyne->cam) matrix
    (eval_outdoor/cam2velodyne.m: inv(Tr) on homogeneous points)."""
    Tr_inv = np.linalg.inv(Tr)
    return points @ Tr_inv[:3, :3].T + Tr_inv[:3, 3]


def cam_to_enu(points: np.ndarray) -> np.ndarray:
    """Camera -> ENU axis flip (eval_repeatability/coord_cam2enu.m):
    e <- x_cam, n <- z_cam, u <- -y_cam."""
    out = np.empty_like(points)
    out[:, 0] = points[:, 0]
    out[:, 1] = points[:, 2]
    out[:, 2] = -points[:, 1]
    return out


def make_coord_fix(kind: str, calib_root: Optional[str] = None):
    """Returns fix(points, seq) -> points for --coord-fix kitti|oxford|none.

    kitti needs calib_root with <seq:02d>/calib.txt (eval_rep.m:70-83);
    oxford is the pure axis flip (eval_rep.m:48,56)."""
    if kind in (None, "none"):
        return None
    if kind == "oxford":
        return lambda pts, seq: cam_to_enu(pts)
    if kind == "kitti":
        if calib_root is None:
            raise ValueError("--coord-fix kitti requires --calib-root")
        cache: Dict[int, np.ndarray] = {}

        def fix(pts, seq):
            if seq not in cache:
                calib = read_kitti_calib(
                    os.path.join(calib_root, f"{seq:02d}", "calib.txt"))
                cache[seq] = calib["Tr"]
            return cam_to_velodyne(pts, cache[seq])

        return fix
    raise ValueError(f"unknown coord fix {kind!r}")


def load_kitti_gt_table(txt_root: str, seq: int) -> List[Dict]:
    """Rows of groundtruths.txt: anc pos tx ty tz qw qx qy qz -> T_gt (4x4)
    mapping pos into the anc frame."""
    rows = []
    with open(os.path.join(txt_root, f"{seq:02d}", "groundtruths.txt")) as f:
        for i, line in enumerate(f):
            if i == 0:
                continue
            p = line.split()
            if len(p) < 9:
                continue
            T = np.eye(4)
            T[:3, :3] = quat_to_rotm(np.asarray(list(map(float, p[5:9]))))
            T[:3, 3] = list(map(float, p[2:5]))
            rows.append({"seq": seq, "anc_idx": int(p[0]), "pos_idx": int(p[1]),
                         "T_gt": T})
    return rows


def run_repeatability(anc_dir: str, pos_dir: str, gt: List[Dict],
                      inlier_radius: float = 0.5,
                      dim: int = 3, coord_fix=None) -> Tuple[float, np.ndarray]:
    """Repeatability over GT pairs; keypoints read from
    ``<dir>/<seq:02d>/<frame>.bin`` trees (the export tool's layout).

    coord_fix: optional fix(points, seq) converting exported (camera-frame)
    keypoints into the GT frame (make_coord_fix; eval_rep.m:48,70-83)."""
    pairs = []
    for row in gt:
        a = read_keypoints_bin(
            os.path.join(anc_dir, f"{row['seq']:02d}", f"{row['anc_idx']}.bin"),
            dim)
        p = read_keypoints_bin(
            os.path.join(pos_dir, f"{row['seq']:02d}", f"{row['pos_idx']}.bin"),
            dim)
        a, p = a[:, :3], p[:, :3]
        if coord_fix is not None:
            a = coord_fix(a, row["seq"])
            p = coord_fix(p, row["seq"])
        pairs.append((a, p, row["T_gt"]))
    return dataset_repeatability(pairs, inlier_radius)


def run_registration(kp_dir: str, desc_dir: str, gt: List[Dict],
                     desc_dim: int = 128, threshold: float = 1.0,
                     max_trials: int = 10000, coord_fix=None):
    """Registration protocol over GT pairs; keypoints and descriptors read from
    parallel .bin trees (evaluate_kitti.m:43-54). coord_fix as in
    run_repeatability (the reference's eval loads keypoints already converted
    by the test-prepare step; ours converts at eval time)."""
    pairs = []
    for row in gt:
        seq = f"{row['seq']:02d}"
        a_kp = read_keypoints_bin(
            os.path.join(kp_dir, seq, f"{row['anc_idx']}.bin"), 3)
        p_kp = read_keypoints_bin(
            os.path.join(kp_dir, seq, f"{row['pos_idx']}.bin"), 3)
        if coord_fix is not None:
            a_kp = coord_fix(a_kp, row["seq"])
            p_kp = coord_fix(p_kp, row["seq"])
        a_d = read_keypoints_bin(
            os.path.join(desc_dir, seq, f"{row['anc_idx']}.bin"), desc_dim)
        p_d = read_keypoints_bin(
            os.path.join(desc_dir, seq, f"{row['pos_idx']}.bin"), desc_dim)
        pairs.append((a_kp, a_d, p_kp, p_d, row["T_gt"]))
    return evaluate_registration(pairs, threshold=threshold,
                                 max_trials=max_trials)


def load_oxford_gt_pkl(root: str) -> List[Dict]:
    """Oxford test groundtruths.pkl: entries with anc_idx/pos_idx/t/q
    (oxford_detector_loader.py:74-76); T_gt maps pos into the anc frame."""
    import pickle
    with open(os.path.join(root, "test_models_20k_np_nofilter",
                           "groundtruths.pkl"), "rb") as f:
        entries = pickle.load(f)
    rows = []
    for e in entries:
        T = np.eye(4)
        T[:3, :3] = quat_to_rotm(np.asarray(e["q"], np.float64))
        T[:3, 3] = np.asarray(e["t"], np.float64).reshape(3)
        rows.append({"seq": 0, "anc_idx": int(e["anc_idx"]),
                     "pos_idx": int(e["pos_idx"]), "T_gt": T})
    return rows


def load_gt_npy_dir(gt_dir: str) -> List[Dict]:
    """Generic GT layout: <gt_dir>/<i>.npy holding a 4x4 transform for pair i
    (anc = <i>.bin in anc tree, pos = <i>.bin in pos tree, seq 0).

    Also accepts the tree ``data/preprocess.build_modelnet_rotated`` writes —
    ``<root>/rotated/<i>_gt.npy`` transforms mixed next to ``<i>.npy`` clouds:
    when any ``*_gt.npy`` exists, ONLY those files are read as transforms (the
    bare ``<i>.npy`` there are point clouds, not GT)."""
    names = sorted(fn for fn in os.listdir(gt_dir) if fn.endswith(".npy"))
    gt_suffixed = [fn for fn in names if fn.endswith("_gt.npy")]
    rows = []
    if gt_suffixed:
        for fn in gt_suffixed:
            i = int(fn[:-len("_gt.npy")])
            rows.append({"seq": 0, "anc_idx": i, "pos_idx": i,
                         "T_gt": np.load(os.path.join(gt_dir, fn))})
        return rows
    for fn in names:
        i = int(os.path.splitext(fn)[0])
        rows.append({"seq": 0, "anc_idx": i, "pos_idx": i,
                     "T_gt": np.load(os.path.join(gt_dir, fn))})
    return rows
