"""Command line of the port (counterpart of ``usip_tpu/cli.py``).

  python -m usip_tpu_torch.cli train-detector --dataset kitti --dataroot TREE \
      [--synthetic] [--epochs E] [--resume auto] [--device cuda]
  python -m usip_tpu_torch.cli export-keypoints --dataset kitti \
      --dataroot TREE --checkpoint ckpt/train/best.pt --out kp/
  python -m usip_tpu_torch.cli eval-repeatability --anc-dir kp --pos-dir kp \
      --kitti-gt TREE/kitti-reg-test --coord-fix kitti --calib-root TREE/calib
  python -m usip_tpu_torch.cli bench [--device cuda]
  python -m usip_tpu_torch.cli detect --input clouds/ --checkpoint w.pth \
      --out served/ [--device cuda]
  python -m usip_tpu_torch.cli serve --checkpoint w.pth [--device cuda]
  python -m usip_tpu_torch.cli serve --dataset oxford \
      --override detector.grouping=ball --checkpoint w.pth

The flags and the request and reply protocol are ``usip_tpu.cli``'s, plus
``--device`` (default ``cuda``, which raises without CUDA rather than run on
the CPU). A checkpoint is the port's own ``.pt`` (what ``train-detector``
writes), a usip_tpu ``.msgpack``, or a reference-named detector
``state_dict`` (``.pth``): the SOM family (``first_pointnet.*``) under the
presets as they are, the grouped family (``conv1..5``, e.g. the released
Oxford ball model) with ``detector.grouping=ball`` or ``knn``.
"""

from __future__ import annotations

import argparse
import glob as globmod
import json
import os
import sys

import numpy as np

from usip_tpu_torch.config import get_config


def _sn_columns(data, s):
    """The sn feature block of an (N, 3+F) cloud, zero-padded when the file
    carries fewer channels than the model expects (the rule of
    ``usip_tpu.cli``); None for an (N, 3) cloud."""
    if data.shape[1] <= 3:
        return None
    sn = data[:, 3:3 + s].astype(np.float32)
    if sn.shape[1] < s:
        sn = np.concatenate(
            [sn, np.zeros((sn.shape[0], s - sn.shape[1]), np.float32)], axis=1)
    return sn


def _parse_overrides(items):
    overrides = {}
    for ov in items:
        k, _, v = ov.partition("=")
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v
    return overrides


def _build_config(args):
    """The preset with ``--override``s, then the run flags a command has
    (``--dataroot``, ``--name``, ...); an explicit ``--override`` wins over
    a flag's default, as in usip_tpu."""
    overrides = _parse_overrides(args.override)
    cfg = get_config(args.dataset, role="detector", **overrides)
    updates = {key: getattr(args, flag) for flag, key in (
        ("dataroot", "data.dataroot"), ("num_devices", "train.num_devices"),
        ("name", "train.name"), ("checkpoints_dir", "train.checkpoint_dir"))
        if getattr(args, flag, None) is not None}
    if getattr(args, "batch_size", None):
        updates["train.batch_size"] = args.batch_size
    if getattr(args, "epochs", None):
        updates["train.epochs"] = args.epochs
    updates = {k: v for k, v in updates.items() if k not in overrides}
    return cfg.with_overrides(**updates) if updates else cfg


def _pipeline(args):
    from usip_tpu_torch.inference import KeypointPipeline
    cfg = _build_config(args)
    return cfg, KeypointPipeline(cfg, args.checkpoint, args.device)


def cmd_detect(args):
    """Keypoints for arbitrary cloud files: each input .npy holds one (N, 3)
    or (N, 3+S) cloud; writes ``<name>.keypoints.bin`` per cloud."""
    paths = sorted(globmod.glob(os.path.join(args.input, "*.npy"))
                   if os.path.isdir(args.input) else globmod.glob(args.input))
    if not paths:
        raise SystemExit(f"no .npy clouds match {args.input}")
    cfg, pipe = _pipeline(args)
    os.makedirs(args.out, exist_ok=True)
    s = cfg.detector.surface_normal_len
    for path in paths:
        data = np.load(path)
        name = os.path.splitext(os.path.basename(path))[0]
        kp, _ = pipe.detect(data[:, :3], _sn_columns(data, s),
                            num_keypoints=args.num_keypoints,
                            nms_radius=args.nms_radius)
        kp.astype(np.float32).tofile(
            os.path.join(args.out, f"{name}.keypoints.bin"))
        print(f"{name}: {kp.shape[0]} keypoints", flush=True)
    print(json.dumps({"clouds": len(paths), "out": args.out}))


def cmd_serve(args):
    """Resident keypoint service: one JSON request per stdin line, one JSON
    reply per stdout line.

    Request:  {"input": "<cloud.npy>", "out": "<dir>", "id": any,
               "num_keypoints": int?, "nms_radius": float?}
    Reply:    {"id": ..., "keypoints": "<path>.keypoints.bin", "n": int}
    Errors reply {"id": ..., "error": "..."} and the loop continues. EOF or
    a {"cmd": "shutdown"} line exits cleanly."""
    cfg, pipe = _pipeline(args)
    s = cfg.detector.surface_normal_len
    print(json.dumps({"status": "ready", "descriptors": False}), flush=True)
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
        except json.JSONDecodeError as e:
            print(json.dumps({"error": f"bad request: {e}"}), flush=True)
            continue
        if not isinstance(req, dict):
            print(json.dumps({"error": "bad request: expected a JSON "
                                       "object"}), flush=True)
            continue
        if req.get("cmd") == "shutdown":
            print(json.dumps({"status": "bye"}), flush=True)
            return
        rid = req.get("id")
        try:
            data = np.load(req["input"])
            out_dir = req.get("out", args.out or ".")
            os.makedirs(out_dir, exist_ok=True)
            name = os.path.splitext(os.path.basename(req["input"]))[0]
            kp, _ = pipe.detect(
                data[:, :3], _sn_columns(data, s),
                num_keypoints=int(req.get("num_keypoints",
                                          args.num_keypoints)),
                nms_radius=float(req.get("nms_radius", args.nms_radius)))
            kpath = os.path.join(out_dir, f"{name}.keypoints.bin")
            kp.astype(np.float32).tofile(kpath)
            print(json.dumps({"id": rid, "keypoints": kpath,
                              "n": int(kp.shape[0])}), flush=True)
        except Exception as e:  # noqa: BLE001 — a bad request must not kill the server
            print(json.dumps({"id": rid,
                              "error": f"{type(e).__name__}: {e}"}),
                  flush=True)


def _make_loaders(cfg, args, sn_len):
    from usip_tpu_torch.data.pipeline import BatchLoader
    if args.synthetic:
        from usip_tpu_torch.data.synthetic import SyntheticDataset
        train_ds = SyntheticDataset(size=64, input_pc_num=cfg.data.input_pc_num,
                                    surface_normal_len=sn_len, seed=0)
        test_ds = SyntheticDataset(size=16, input_pc_num=cfg.data.input_pc_num,
                                   surface_normal_len=sn_len, seed=1)
    else:
        from usip_tpu_torch.data.loaders import (ConcatSiameseDataset,
                                                 ParentCloudDataset,
                                                 make_detector_dataset)
        train_ds = make_detector_dataset(cfg.data.dataset, cfg.data, "train",
                                         sn_len)
        if cfg.data.dataset == "scenenn":
            # scenenn trains on train+val (scenenn/train_detector.py:55-60)
            try:
                val_ds = make_detector_dataset(cfg.data.dataset, cfg.data,
                                               "val", sn_len)
                train_ds = ConcatSiameseDataset([train_ds, val_ds])
            except (FileNotFoundError, OSError):
                pass  # no val split on disk
        test_ds = make_detector_dataset(cfg.data.dataset, cfg.data, "test",
                                        sn_len)
        if cfg.data.device_sampling:
            # ship the parent cloud once; siamese subsamples drawn on device
            train_ds = ParentCloudDataset(train_ds)
            test_ds = ParentCloudDataset(test_ds)
    train = BatchLoader(train_ds, cfg.train.batch_size, shuffle=True,
                        num_workers=cfg.data.num_workers)
    test = BatchLoader(test_ds, cfg.train.batch_size, shuffle=False,
                       num_workers=cfg.data.num_workers)
    return train, test


def cmd_train_detector(args):
    """Train the detector; checkpoints, ``config.json`` and
    ``<name>_metrics.jsonl`` go to ``<checkpoints-dir>/<name>/``."""
    cfg = _build_config(args)
    if args.lite:
        # indoor widths (RPN_DetectorLite, networks.py:165-307), for a
        # detector that feeds an indoor descriptor pipeline; explicit
        # --override detector.* entries keep precedence over --lite
        import dataclasses

        from usip_tpu_torch.config import lite_detector
        cfg = dataclasses.replace(cfg, detector=lite_detector(cfg.detector))
        det = {k: v for k, v in _parse_overrides(args.override).items()
               if k.startswith("detector.")}
        if det:
            cfg = cfg.with_overrides(**det)
    from usip_tpu_torch.train.loop import DetectorEngine
    train, test = _make_loaders(cfg, args, cfg.detector.surface_normal_len)
    engine = DetectorEngine(cfg, train, test, profile_dir=args.profile_dir,
                            device=args.device)
    if args.resume:
        path = args.resume
        if path == "auto":
            path = os.path.join(engine.out_dir, "last.pt")
        start = engine.resume(path)
        print(f"resumed from {path} at epoch {start}", flush=True)
    engine.fit()


def cmd_export_keypoints(args):
    cfg = _build_config(args)
    if args.downsample_rate > 1:
        # the export tool's robustness knob: detect on 1/rate of the points
        # (save_keypoints.py:35,116 input_pc_num /= downsample_rate)
        cfg = cfg.with_overrides(**{
            "data.input_pc_num": cfg.data.input_pc_num // args.downsample_rate})
    if args.method == "model" and not args.checkpoint:
        raise SystemExit("export-keypoints --method model needs --checkpoint")
    from usip_tpu_torch.eval.export_runner import run_export
    stats = run_export(cfg, checkpoint=args.checkpoint, out_dir=args.out,
                       nms_radius=args.nms_radius,
                       desired_num=args.num_keypoints,
                       synthetic=args.synthetic, method=args.method,
                       noise_sigma=args.noise_sigma,
                       with_sigmas=args.with_sigmas, device=args.device)
    print(json.dumps(stats), flush=True)


def _load_gt(args):
    from usip_tpu_torch.eval.eval_runner import (load_gt_npy_dir,
                                                 load_kitti_gt_table,
                                                 load_oxford_gt_pkl)
    if args.kitti_gt:
        gt = []
        for seq in (9, 10):
            gt.extend(load_kitti_gt_table(args.kitti_gt, seq))
        return gt
    if args.oxford_root:
        return load_oxford_gt_pkl(args.oxford_root)
    if not args.gt_dir:
        raise SystemExit("no groundtruth source: pass --gt-dir, --kitti-gt, "
                         "or --oxford-root")
    gt = load_gt_npy_dir(args.gt_dir)
    if not gt:
        raise SystemExit(f"no GT pairs found in --gt-dir {args.gt_dir!r} "
                         "(expected <i>.npy or <i>_gt.npy 4x4 transforms)")
    return gt


def cmd_eval_repeatability(args):
    from usip_tpu_torch.eval.eval_runner import make_coord_fix, run_repeatability
    gt = _load_gt(args)
    mean, arr = run_repeatability(
        args.anc_dir, args.pos_dir, gt, inlier_radius=args.inlier_radius,
        coord_fix=make_coord_fix(args.coord_fix, args.calib_root))
    print(json.dumps({"repeatability": mean, "pairs": len(arr),
                      "min": float(arr.min()), "max": float(arr.max())}),
          flush=True)


def cmd_bench(args):
    from usip_tpu_torch.bench import main as bench_main
    bench_main(["--device", args.device])


def _add_config_flags(p):
    p.add_argument("--dataset", default="kitti",
                   choices=["modelnet", "shrec", "oxford", "kitti", "scenenn",
                            "match3d"])
    p.add_argument("--override", action="append", default=[],
                   help="dotted config override, e.g. data.input_pc_num=4096")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' fails when CUDA is absent")


def _add_run_flags(p):
    """usip_tpu's common train/export flags (the multi-host ones are not
    ported)."""
    _add_config_flags(p)
    p.add_argument("--dataroot", default="")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--num-devices", type=int, default=1,
                   help="devices to train on; the port trains on one")
    p.add_argument("--name", default="train")
    p.add_argument("--checkpoints-dir", default="checkpoints")
    p.add_argument("--synthetic", action="store_true",
                   help="use the in-memory synthetic dataset (smoke runs)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of one steady-state "
                        "train step here")


def _add_common(p):
    _add_config_flags(p)
    p.add_argument("--checkpoint", required=True,
                   help="detector checkpoint: the port's .pt, a usip_tpu "
                        ".msgpack or a reference-named state_dict (.pth)")
    p.add_argument("--num-keypoints", type=int, default=128)
    p.add_argument("--nms-radius", type=float, default=0.0)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="usip_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("train-detector")
    _add_run_flags(p)
    p.add_argument("--resume", default=None,
                   help="checkpoint path (the port's .pt, or a usip_tpu "
                        ".msgpack: its Adam moments are not carried over), "
                        "or 'auto' for <out_dir>/last.pt")
    p.add_argument("--lite", action="store_true",
                   help="indoor lite widths (c1=64/c2=256, RPN_DetectorLite)")
    p.set_defaults(fn=cmd_train_detector)

    p = sub.add_parser("export-keypoints")
    _add_run_flags(p)
    p.add_argument("--checkpoint", default=None,
                   help="detector checkpoint (.pt or usip_tpu .msgpack)")
    p.add_argument("--out", required=True)
    p.add_argument("--nms-radius", type=float, default=0.0)
    p.add_argument("--num-keypoints", type=int, default=128)
    p.add_argument("--method", default="model", choices=["model", "random"],
                   help="trained detector or random keypoints (the ISS, "
                        "Harris and SIFT baselines are not ported)")
    p.add_argument("--noise-sigma", type=float, default=0.0)
    p.add_argument("--downsample-rate", type=int, default=1,
                   help="detect on input_pc_num/rate points "
                        "(save_keypoints.py downsample_rate)")
    p.add_argument("--with-sigmas", action="store_true",
                   help="write 4-column (xyz, sigma) bins")
    p.set_defaults(fn=cmd_export_keypoints)

    p = sub.add_parser("eval-repeatability")
    p.add_argument("--anc-dir", required=True)
    p.add_argument("--pos-dir", required=True)
    p.add_argument("--gt-dir", default=None)
    p.add_argument("--kitti-gt", default=None,
                   help="kitti-reg-test root with <seq>/groundtruths.txt")
    p.add_argument("--oxford-root", default=None,
                   help="oxford dataroot (reads test groundtruths.pkl)")
    p.add_argument("--inlier-radius", type=float, default=0.5)
    p.add_argument("--coord-fix", default="none",
                   choices=["none", "kitti", "oxford"],
                   help="convert exported camera-frame keypoints into the GT "
                        "frame (eval_rep.m:48,70-83)")
    p.add_argument("--calib-root", default=None,
                   help="kitti calib tree <root>/<seq:02d>/calib.txt")
    p.set_defaults(fn=cmd_eval_repeatability)

    p = sub.add_parser("bench", help="detect throughput on the card: one "
                       "JSON line")
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("detect", help="keypoints for .npy cloud files")
    _add_common(p)
    p.add_argument("--input", required=True,
                   help="directory of .npy clouds, or a glob")
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_detect)

    p = sub.add_parser("serve", help="resident keypoint service: JSON "
                       "requests on stdin, JSON replies on stdout")
    _add_common(p)
    p.add_argument("--out", default=None,
                   help="default output dir when requests omit 'out'")
    p.set_defaults(fn=cmd_serve)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
