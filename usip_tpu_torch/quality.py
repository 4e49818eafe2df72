"""The training-quality gate through the port (counterpart of
``scripts/fullscale_quality.py phase_smoke``):

    python -m usip_tpu_torch.quality [--root DIR] [--epochs 16] \
        [--factor 2] [--device cuda] [--override data.node_num=64 ...]

At the KITTI preset's semantics (device sampling of fp16 parent clouds, bf16
trunk, exact FPS) and phase_smoke's reduced sizes (input 2048 points,
parent 2560, 64 nodes, c1 32, c2 128, batch 4; a synthetic KITTI tree of
4096-point scans, 9 train sequences of 6 frames and 2 test sequences of
10), it builds the tree, trains ``--epochs`` epochs through ``python -m
usip_tpu_torch.cli train-detector``, exports 64 keypoints a test frame with
the trained detector and with random keypoints, scores both with the KITTI
repeatability protocol (``--coord-fix kitti``, inlier radius 0.5 m), prints
one JSON line, and exits nonzero unless trained/random >= ``--factor``.
``--override``s come after the reduced sizes, so they win.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

# phase_smoke's reduced sizes (scripts/fullscale_quality.py:305-316); every
# semantic lever (device sampling, fp16 wire, bf16 trunk, FPS) stays at the
# preset's value
SMOKE_OVERRIDES = [
    "data.input_pc_num=2048", "data.parent_pc_num=2560",
    "data.node_num=64", "detector.c1=32", "detector.c2=128",
    "train.batch_size=4", "train.log_every=50",
]
NAME = "fullscale"


def _overrides(items):
    from usip_tpu_torch.cli import _parse_overrides
    return _parse_overrides(items)


def export_and_repeatability(cfg, checkpoint, out_dir, gt, calib_root,
                             device, desired=64, inlier_radius=0.5):
    """Export the test frames (the trained detector, or random keypoints
    when ``checkpoint`` is None) and score their repeatability."""
    from usip_tpu_torch.data.eval_loaders import KittiTestFrames
    from usip_tpu_torch.eval.eval_runner import (make_coord_fix,
                                                 run_repeatability)
    from usip_tpu_torch.eval.export_runner import run_export
    ds = KittiTestFrames(
        cfg.data, txt_root=os.path.join(cfg.data.dataroot, "kitti-reg-test"),
        numpy_root=os.path.join(cfg.data.dataroot, "data_odometry_velodyne",
                                "numpy"), seqs=(9, 10),
        sn_len=cfg.detector.surface_normal_len, seed=0)
    stats = run_export(cfg, checkpoint, out_dir, desired_num=desired,
                       dataset=ds, device=device,
                       method="model" if checkpoint else "random")
    mean, arr = run_repeatability(out_dir, out_dir, gt,
                                  inlier_radius=inlier_radius,
                                  coord_fix=make_coord_fix("kitti", calib_root))
    return {"frames": stats["frames"], "repeatability": float(mean),
            "pairs": len(arr)}


def run(root: str, epochs: int = 16, factor: float = 2.0, device="cuda",
        overrides=(), frames: int = 6, test_frames: int = 10,
        points: int = 4096) -> dict:
    """The gate's phases in order; returns its result (``passed`` among
    them) without raising on a low ratio."""
    from usip_tpu_torch.cli import main as cli_main
    from usip_tpu_torch.config import get_config
    from usip_tpu_torch.data.synthetic import build_synthetic_kitti_tree
    from usip_tpu_torch.eval.eval_runner import load_kitti_gt_table
    from usip_tpu_torch.inference import resolve_device
    from usip_tpu_torch.train.checkpoint import find_checkpoint

    resolve_device(device)  # fail before the tree is built
    seconds = {}
    t0 = time.perf_counter()
    # all 9 train seqs (the kitti loader's fixed seq contract), few frames each
    build_synthetic_kitti_tree(root, train_seqs=range(9), test_seqs=(9, 10),
                               frames_per_seq=frames,
                               test_frames_per_seq=test_frames,
                               target_points=points, seed=0)
    seconds["gen"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ckpt_dir = os.path.join(root, "ckpt")
    argv = ["train-detector", "--dataset", "kitti", "--dataroot", root,
            "--name", NAME, "--epochs", str(epochs),
            "--checkpoints-dir", ckpt_dir, "--device", str(device)]
    for kv in list(SMOKE_OVERRIDES) + list(overrides):
        argv += ["--override", kv]
    cli_main(argv)
    seconds["train"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    gt = []
    for seq in (9, 10):
        gt.extend(load_kitti_gt_table(os.path.join(root, "kitti-reg-test"),
                                      seq))
    calib_root = os.path.join(root, "calib")
    cfg = get_config("kitti", **{
        "data.dataroot": root, "train.checkpoint_dir": ckpt_dir,
        "train.name": NAME,
        **_overrides(list(SMOKE_OVERRIDES) + list(overrides))})
    ckpt = find_checkpoint(os.path.join(ckpt_dir, NAME))
    trained = export_and_repeatability(
        cfg, ckpt, os.path.join(root, "kp_smoke"), gt, calib_root, device)
    random_kp = export_and_repeatability(
        cfg, None, os.path.join(root, "kp_smoke_rand"), gt, calib_root,
        device)
    seconds["eval"] = time.perf_counter() - t0
    ratio = trained["repeatability"] / max(random_kp["repeatability"], 1e-9)
    return {"phase": "smoke", "pairs": len(gt), "checkpoint": ckpt,
            "trained": trained, "random": random_kp, "ratio": ratio,
            "factor": factor, "passed": bool(ratio >= factor),
            "seconds": seconds}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="usip_tpu_torch.quality")
    ap.add_argument("--root", default=None,
                    help="working dir (default: a fresh temp dir)")
    ap.add_argument("--epochs", type=int, default=16)
    ap.add_argument("--factor", type=float, default=2.0,
                    help="required trained/random repeatability ratio")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' fails when CUDA is absent")
    ap.add_argument("--cleanup", action="store_true",
                    help="remove the working dir on success")
    ap.add_argument("--override", action="append", default=[],
                    help="dotted config override, after the reduced sizes")
    args = ap.parse_args(argv)
    root = args.root or tempfile.mkdtemp(prefix="usip_smoke_")
    result = run(root, args.epochs, args.factor, args.device, args.override)
    print(json.dumps(result), flush=True)
    if args.cleanup and result["passed"]:
        shutil.rmtree(root, ignore_errors=True)
    if not result["passed"]:
        raise SystemExit(
            f"smoke gate FAILED: trained/random repeatability "
            f"{result['ratio']:.2f} < required {args.factor}")
    return result


if __name__ == "__main__":
    main()
