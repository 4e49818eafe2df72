"""The full-scale KITTI protocol through the port (counterpart of
``scripts/fullscale_quality.py``): train the ACTUAL kitti preset (N=16384,
M=512, c1=128/c2=512, bf16 trunk, device sampling of fp16 parent clouds) on
a synthetic KITTI-style disk tree, export keypoints, and run the kitti
repeatability protocol with the cam->velodyne coordinate fix; then the
complete pipeline (the reference's headline KITTI protocol, evaluate_kitti.m:
detector keypoints + descriptors + 1-NN matching + RANSAC registration).

Phases (run separately so the long trains can sit in the background):

  python -m usip_tpu_torch.fullscale gen        [--root R] [--frames 48] [--test-frames 36]
  python -m usip_tpu_torch.fullscale train      [--root R] [--epochs 40]
  python -m usip_tpu_torch.fullscale eval       [--root R]
  python -m usip_tpu_torch.fullscale train-desc [--root R] [--epochs 30] [--desc-name N]
  python -m usip_tpu_torch.fullscale eval-reg   [--root R] [--yaw] [--desc-name N]
  python -m usip_tpu_torch.fullscale smoke      [--root R] [--epochs 16] [--factor 2] [--cleanup]

``eval`` prints one JSON line with repeatability for: trained/defaults,
trained/fp32+exact-FPS, untrained/defaults (seed 123), random keypoints, and
the defaults-minus-exact delta. ``eval-reg`` exports keypoint+descriptor
``.bin`` trees with the trained detector and A/Bs the trained descriptor
against an untrained one (seed 321) and random unit vectors through
``run_registration`` (RTE <= 2 m, RRE <= 5 deg success, coord-fixed);
``--yaw`` adds the per-frame-yaw arms. ``smoke`` is the detector's quality
gate, ``python -m usip_tpu_torch.quality`` (phase_smoke's reduced sizes).

The script's phases, flags, defaults and JSON lines, with the port's
checkpoints (``best.pt``/``last.pt`` in place of ``.msgpack``) and
``--device`` (default ``cuda``, which raises without CUDA) in place of
``--platform``. The default root is ``synth_kitti`` under the temporary
directory (``TMPDIR``).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

NAME = "fullscale"
TEST_SEQS = (9, 10)


def phase_gen(args):
    from usip_tpu_torch.data.synthetic import build_synthetic_kitti_tree
    counts = build_synthetic_kitti_tree(
        args.root, frames_per_seq=args.frames,
        test_frames_per_seq=args.test_frames, spacing=1.5, seed=0)
    print(json.dumps({"phase": "gen", "root": args.root, "counts": counts}),
          flush=True)


def _parse_overrides(args):
    from usip_tpu_torch.cli import _parse_overrides
    return _parse_overrides(args.override)


def _ckpt_dir(root):
    return os.path.join(root, "ckpt")


def _cfg(args, **extra):
    from usip_tpu_torch.config import get_config
    over = {"data.dataroot": args.root, "train.batch_size": 8,
            "train.checkpoint_dir": _ckpt_dir(args.root), "train.name": NAME}
    over.update(_parse_overrides(args))
    over.update(extra)
    return get_config("kitti", **over)


def _cli_overrides(args):
    argv = []
    for kv in args.override:
        argv += ["--override", kv]
    return argv


def phase_train(args):
    from usip_tpu_torch.cli import main as cli_main
    cli_main(["train-detector", "--dataset", "kitti", "--dataroot", args.root,
              "--name", NAME, "--epochs", str(args.epochs),
              "--checkpoints-dir", _ckpt_dir(args.root),
              "--override", "train.log_every=20", "--device", args.device]
             + _cli_overrides(args))


def _best_or_last(folder):
    ckpt = os.path.join(folder, "best.pt")
    return ckpt if os.path.exists(ckpt) else os.path.join(folder, "last.pt")


def _detector_ckpt(root):
    return _best_or_last(os.path.join(_ckpt_dir(root), NAME))


def _gt_and_calib(root):
    from usip_tpu_torch.eval.eval_runner import load_kitti_gt_table
    gt = []
    for seq in TEST_SEQS:
        gt.extend(load_kitti_gt_table(os.path.join(root, "kitti-reg-test"),
                                      seq))
    return gt, os.path.join(root, "calib")


def _export_and_rep(cfg, checkpoint, out_dir, gt, calib_root, device):
    """128 keypoints a test frame (the trained or untrained detector, or
    random keypoints when ``checkpoint`` is None), scored at 0.5 m."""
    from usip_tpu_torch.quality import export_and_repeatability
    return export_and_repeatability(cfg, checkpoint, out_dir, gt, calib_root,
                                    device, desired=128, inlier_radius=0.5)


def phase_eval(args):
    from usip_tpu_torch.train.checkpoint import save_checkpoint
    from usip_tpu_torch.train.loop import init_detector_state

    gt, calib_root = _gt_and_calib(args.root)
    ckpt = _detector_ckpt(args.root)
    results = {"phase": "eval", "pairs": len(gt)}

    # 1. trained model, shipped defaults (bf16 trunk, the preset's FPS)
    cfg = _cfg(args)
    results["trained_defaults"] = _export_and_rep(
        cfg, ckpt, os.path.join(args.root, "kp_default"), gt, calib_root,
        args.device)

    # 2. trained model, fp32 + exact FPS (the parity-exact inference path)
    cfg_exact = _cfg(args, **{"detector.compute_dtype": "float32",
                              "data.fps_parallel": 1})
    results["trained_fp32_exact"] = _export_and_rep(
        cfg_exact, ckpt, os.path.join(args.root, "kp_exact"), gt, calib_root,
        args.device)

    # 3. untrained (random-init) detector, defaults: the learning delta
    cfg_u = _cfg(args)
    upath = os.path.join(_ckpt_dir(args.root), "untrained.pt")
    save_checkpoint(upath, init_detector_state(cfg_u, seed=123))
    results["untrained_defaults"] = _export_and_rep(
        cfg_u, upath, os.path.join(args.root, "kp_untrained"), gt,
        calib_root, args.device)

    # 4. random keypoints baseline
    results["random_keypoints"] = _export_and_rep(
        _cfg(args), None, os.path.join(args.root, "kp_random"), gt,
        calib_root, args.device)

    d = results["trained_defaults"]["repeatability"]
    e = results["trained_fp32_exact"]["repeatability"]
    results["default_vs_exact_delta"] = d - e
    print(json.dumps(results), flush=True)
    return results


def phase_train_desc(args):
    """The kitti-preset descriptor on the frozen full-scale detector
    (reference kitti/train_descriptor.py: frozen detector + scan triplet /
    pose-distance negative mining). ``--desc-name`` trains another arm (the
    CGF keypoint triplet: ``--desc-name cgf --override
    descriptor.use_cgf_loss=true``)."""
    from usip_tpu_torch.cli import main as cli_main
    cli_main(["train-descriptor", "--dataset", "kitti",
              "--dataroot", args.root, "--name", args.desc_name,
              "--epochs", str(args.epochs),
              "--checkpoints-dir", _ckpt_dir(args.root),
              "--detector-checkpoint", _detector_ckpt(args.root),
              "--override", "train.log_every=20", "--device", args.device]
             + _cli_overrides(args))


def _export_and_reg(cfg, det_ckpt, desc_ckpt, out_root, gt, calib_root,
                    device, desired=128, max_trials=10000,
                    frame_yaw_seed=None):
    from usip_tpu_torch.data.eval_loaders import KittiTestFrames
    from usip_tpu_torch.eval.eval_runner import (make_coord_fix,
                                                 run_registration)
    from usip_tpu_torch.eval.export_runner import run_export_with_descriptors

    ds = KittiTestFrames(
        cfg.data, txt_root=os.path.join(cfg.data.dataroot, "kitti-reg-test"),
        numpy_root=os.path.join(cfg.data.dataroot, "data_odometry_velodyne",
                                "numpy"), seqs=TEST_SEQS,
        sn_len=cfg.detector.surface_normal_len, seed=0)
    kp_dir = os.path.join(out_root, "keypoints")
    desc_dir = os.path.join(out_root, "descriptors")
    stats = run_export_with_descriptors(
        cfg, detector_checkpoint=det_ckpt, descriptor_checkpoint=desc_ckpt,
        kp_out=kp_dir, desc_out=desc_dir, desired_num=desired, dataset=ds,
        frame_yaw_seed=frame_yaw_seed, device=device)
    res = run_registration(kp_dir, desc_dir, gt,
                           desc_dim=cfg.descriptor.descriptor_len,
                           max_trials=max_trials,
                           coord_fix=make_coord_fix("kitti", calib_root))
    return {"frames": stats["frames"], **res._asdict()}


def phase_eval_reg(args):
    """Full-pipeline registration A/B: trained against untrained
    descriptor, both on the trained detector's keypoints (evaluate_kitti.m:
    1-NN matching -> RANSAC -> success iff RTE <= 2 m and RRE <= 5 deg)."""
    from usip_tpu_torch.train.checkpoint import save_checkpoint
    from usip_tpu_torch.train.descriptor_loop import init_descriptor_state

    gt, calib_root = _gt_and_calib(args.root)
    det_ckpt = _detector_ckpt(args.root)
    desc_ckpt = _best_or_last(os.path.join(_ckpt_dir(args.root),
                                           f"{args.desc_name}_descriptor"))
    cfg = _cfg(args)
    trained_dir = (os.path.join(args.root, f"reg_trained_{args.desc_name}")
                   if args.desc_name != NAME
                   else os.path.join(args.root, "reg_trained"))
    results = {"phase": "eval-reg", "pairs": len(gt),
               "desc_name": args.desc_name}
    results["trained_desc"] = _export_and_reg(
        cfg, det_ckpt, desc_ckpt, trained_dir, gt, calib_root, args.device)

    # untrained (random-init) descriptor on the same trained keypoints:
    # what descriptor learning adds to the end metric
    upath = os.path.join(_ckpt_dir(args.root), "untrained_desc.pt")
    save_checkpoint(upath, init_descriptor_state(cfg, seed=321))
    results["untrained_desc"] = _export_and_reg(
        cfg, det_ckpt, upath, os.path.join(args.root, "reg_untrained"), gt,
        calib_root, args.device)

    # the random-descriptor floor: the same trained keypoints, random unit
    # vectors for descriptors; what keypoint geometry alone gives RANSAC
    results["random_desc_floor"] = _random_desc_arm(
        args, cfg, gt, calib_root,
        kp_dir=os.path.join(trained_dir, "keypoints"))

    if args.yaw:
        # the discriminating protocol: a random yaw a frame applied to every
        # cloud before detect + describe (keypoints rotated back, GT
        # unchanged); aligned synthetic frames are solvable by yaw-variant
        # untrained ball features
        results["trained_desc_yaw"] = _export_and_reg(
            cfg, det_ckpt, desc_ckpt, trained_dir + "_yaw", gt, calib_root,
            args.device, frame_yaw_seed=7)
        results["untrained_desc_yaw"] = _export_and_reg(
            cfg, det_ckpt, upath,
            os.path.join(args.root, "reg_untrained_yaw"), gt, calib_root,
            args.device, frame_yaw_seed=7)
    print(json.dumps(results), flush=True)
    return results


def _random_desc_arm(args, cfg, gt, calib_root, seed=17, kp_dir=None):
    """Random unit vectors (numpy ``default_rng(seed)``, frame by frame in
    sorted order) as the descriptors of ``kp_dir``'s keypoints, registered
    as the other arms are."""
    from usip_tpu_torch.eval.eval_runner import (make_coord_fix,
                                                 run_registration)

    if kp_dir is None:
        kp_dir = os.path.join(args.root, "reg_trained", "keypoints")
    desc_dir = os.path.join(args.root, "reg_randomdesc", "descriptors")
    d = cfg.descriptor.descriptor_len
    rng = np.random.default_rng(seed)
    frames = 0
    for seq in sorted(os.listdir(kp_dir)):
        os.makedirs(os.path.join(desc_dir, seq), exist_ok=True)
        for fn in sorted(os.listdir(os.path.join(kp_dir, seq))):
            kp = np.fromfile(os.path.join(kp_dir, seq, fn),
                             np.float32).reshape(-1, 3)
            vec = rng.normal(size=(kp.shape[0], d)).astype(np.float32)
            vec /= np.linalg.norm(vec, axis=1, keepdims=True) + 1e-12
            vec.tofile(os.path.join(desc_dir, seq, fn))
            frames += 1
    res = run_registration(kp_dir, desc_dir, gt, desc_dim=d,
                           max_trials=10000,
                           coord_fix=make_coord_fix("kitti", calib_root))
    return {"frames": frames, **res._asdict()}


def phase_smoke(args):
    """The production-preset quality gate: ``python -m
    usip_tpu_torch.quality`` (phase_smoke's reduced sizes and semantics;
    exits nonzero below ``--factor``)."""
    from usip_tpu_torch import quality
    argv = ["--factor", str(args.factor), "--device", args.device]
    if args.root:
        argv += ["--root", args.root]
    if args.epochs:
        argv += ["--epochs", str(args.epochs)]
    if args.cleanup:
        argv.append("--cleanup")
    return quality.main(argv + _cli_overrides(args))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="usip_tpu_torch.fullscale")
    sub = ap.add_subparsers(dest="phase", required=True)
    root = os.path.join(tempfile.gettempdir(), "synth_kitti")
    g = sub.add_parser("gen")
    g.add_argument("--frames", type=int, default=48)
    g.add_argument("--test-frames", type=int, default=36)
    g.set_defaults(fn=phase_gen)
    t = sub.add_parser("train")
    t.add_argument("--epochs", type=int, default=40)
    t.set_defaults(fn=phase_train)
    e = sub.add_parser("eval")
    e.set_defaults(fn=phase_eval)
    td = sub.add_parser("train-desc")
    td.add_argument("--epochs", type=int, default=30)
    td.set_defaults(fn=phase_train_desc)
    er = sub.add_parser("eval-reg")
    er.add_argument("--yaw", action="store_true",
                    help="add per-frame-yaw arms (trained/untrained): the "
                         "discriminating rotation protocol")
    er.set_defaults(fn=phase_eval_reg)
    for p in (td, er):
        p.add_argument("--desc-name", default=NAME,
                       help="descriptor arm name: checkpoints live in "
                            "ckpt/<name>_descriptor (e.g. train a CGF arm "
                            "with --desc-name cgf --override "
                            "descriptor.use_cgf_loss=true)")
    sm = sub.add_parser("smoke")
    sm.add_argument("--epochs", type=int, default=None)
    sm.add_argument("--factor", type=float, default=2.0,
                    help="required trained/random repeatability ratio")
    sm.add_argument("--cleanup", action="store_true",
                    help="remove the working dir on success")
    sm.set_defaults(fn=phase_smoke)
    for p in (g, t, e, td, er, sm):
        p.add_argument("--root", default=None if p is sm else root,
                       help="working dir" + (" (default: a fresh temp dir)"
                                             if p is sm else ""))
        p.add_argument("--override", action="append", default=[],
                       help="dotted config override, e.g. detector.c1=32 "
                            "(repeatable; lets the protocol run at reduced "
                            "scale, e.g. a CPU smoke test)")
    for p in (t, e, td, er, sm):
        p.add_argument("--device", default="cuda",
                       help="torch device; 'cuda' fails when CUDA is absent")
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
