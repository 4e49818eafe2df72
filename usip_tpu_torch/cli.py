"""Command line of the port (counterpart of ``usip_tpu/cli.py``).

  python -m usip_tpu_torch.cli train-detector --dataset kitti --dataroot TREE \
      [--synthetic] [--epochs E] [--resume auto] [--device cuda]
  python -m usip_tpu_torch.cli train-descriptor --dataset kitti \
      --dataroot TREE --detector-checkpoint ckpt/train/best.pt \
      [--synthetic] [--epochs E] [--resume auto]
  python -m usip_tpu_torch.cli export-keypoints --dataset kitti \
      --dataroot TREE --checkpoint ckpt/train/best.pt --out kp/
  python -m usip_tpu_torch.cli export-descriptors --dataset kitti \
      --dataroot TREE --checkpoint ckpt/train/best.pt \
      --descriptor-checkpoint ckpt/train_descriptor/best.pt --out feats/
  python -m usip_tpu_torch.cli eval-repeatability --anc-dir kp --pos-dir kp \
      --kitti-gt TREE/kitti-reg-test --coord-fix kitti --calib-root TREE/calib
  python -m usip_tpu_torch.cli eval-registration --kp-dir feats/keypoints \
      --desc-dir feats/descriptors --kitti-gt TREE/kitti-reg-test \
      --coord-fix kitti --calib-root TREE/calib [--sweep-trials 100,1000]
  python -m usip_tpu_torch.cli bench [--device cuda]
  python -m usip_tpu_torch.cli detect --input clouds/ --checkpoint w.pth \
      --out served/ [--descriptor-checkpoint d.pt] [--device cuda]
  python -m usip_tpu_torch.cli serve --checkpoint w.pth \
      [--descriptor-checkpoint d.pt] [--device cuda]
  python -m usip_tpu_torch.cli serve --dataset oxford \
      --override detector.grouping=ball --checkpoint w.pth

The flags and the request and reply protocol are ``usip_tpu.cli``'s, plus
``--device`` (default ``cuda``, which raises without CUDA rather than run on
the CPU). A checkpoint is the port's own ``.pt`` (what ``train-detector``
writes), a usip_tpu ``.msgpack``, or a reference-named detector
``state_dict`` (``.pth``): the SOM family (``first_pointnet.*``) under the
presets as they are, the grouped family (``conv1..5``, e.g. the released
Oxford ball model) with ``detector.grouping=ball`` or ``knn``. With a
descriptor (``--descriptor-checkpoint``, and the descriptor commands) the
config is the preset's descriptor role, as in usip_tpu. ``train-descriptor
--resume`` is the port's (usip_tpu's engine resumes, its command does not
take the flag).
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


def _build_config(args, role="detector"):
    """The preset of ``role`` with ``--override``s, then the run flags a
    command has (``--dataroot``, ``--name``, ...); an explicit
    ``--override`` wins over a flag's default, as in usip_tpu."""
    overrides = _parse_overrides(args.override)
    cfg = get_config(args.dataset, role=role, **overrides)
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
    """The pipeline of ``detect``/``serve``; with a descriptor the
    descriptor-role config (its engine trained the frozen detector at
    those widths)."""
    from usip_tpu_torch.inference import KeypointPipeline
    desc = args.descriptor_checkpoint
    cfg = _build_config(args, role="descriptor" if desc else "detector")
    return cfg, KeypointPipeline(cfg, args.checkpoint, args.device,
                                 descriptor_checkpoint=desc)


def _detect_one(pipe, args, data, s, out_dir, name, nk, nms):
    """Keypoints (and descriptors) of one cloud written to ``out_dir``:
    ``{"keypoints": path, "descriptors": path?, "n": count}``."""
    pc, sn = data[:, :3], _sn_columns(data, s)
    reply = {}
    if args.descriptor_checkpoint:
        kp, desc = pipe.detect_and_describe(pc, sn, num_keypoints=nk,
                                            nms_radius=nms)
        dpath = os.path.join(out_dir, f"{name}.desc.bin")
        desc.astype(np.float32).tofile(dpath)
        reply["descriptors"] = dpath
    else:
        kp, _ = pipe.detect(pc, sn, num_keypoints=nk, nms_radius=nms)
    kpath = os.path.join(out_dir, f"{name}.keypoints.bin")
    kp.astype(np.float32).tofile(kpath)
    return {"keypoints": kpath, **reply, "n": int(kp.shape[0])}


def cmd_detect(args):
    """Keypoints (and descriptors) for arbitrary cloud files: each input
    .npy holds one (N, 3) or (N, 3+S) cloud; writes
    ``<name>.keypoints.bin`` (and ``<name>.desc.bin``) per cloud."""
    paths = sorted(globmod.glob(os.path.join(args.input, "*.npy"))
                   if os.path.isdir(args.input) else globmod.glob(args.input))
    if not paths:
        raise SystemExit(f"no .npy clouds match {args.input}")
    cfg, pipe = _pipeline(args)
    os.makedirs(args.out, exist_ok=True)
    s = cfg.detector.surface_normal_len
    for path in paths:
        name = os.path.splitext(os.path.basename(path))[0]
        reply = _detect_one(pipe, args, np.load(path), s, args.out, name,
                            args.num_keypoints, args.nms_radius)
        print(f"{name}: {reply['n']} keypoints", flush=True)
    print(json.dumps({"clouds": len(paths), "out": args.out}))


def cmd_serve(args):
    """Resident keypoint service: one JSON request per stdin line, one JSON
    reply per stdout line.

    Request:  {"input": "<cloud.npy>", "out": "<dir>", "id": any,
               "num_keypoints": int?, "nms_radius": float?}
    Reply:    {"id": ..., "keypoints": "<path>.keypoints.bin",
               "descriptors": "<path>.desc.bin"?, "n": int}
    Errors reply {"id": ..., "error": "..."} and the loop continues. EOF or
    a {"cmd": "shutdown"} line exits cleanly."""
    cfg, pipe = _pipeline(args)
    s = cfg.detector.surface_normal_len
    print(json.dumps({"status": "ready",
                      "descriptors": args.descriptor_checkpoint is not None}),
          flush=True)
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
            reply = _detect_one(
                pipe, args, data, s, out_dir, name,
                int(req.get("num_keypoints", args.num_keypoints)),
                float(req.get("nms_radius", args.nms_radius)))
            print(json.dumps({"id": rid, **reply}), flush=True)
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


def cmd_train_descriptor(args):
    """Train the descriptor on the frozen detector of
    ``--detector-checkpoint``; checkpoints and ``<name>_desc_metrics.jsonl``
    go to ``<checkpoints-dir>/<name>_descriptor/``."""
    cfg = _build_config(args, role="descriptor")
    from usip_tpu_torch.train.descriptor_loop import DescriptorEngine
    if args.synthetic:
        engine = DescriptorEngine(cfg, args.detector_checkpoint,
                                  synthetic=True, device=args.device)
    else:
        from usip_tpu_torch.data import descriptor_loaders as dl
        from usip_tpu_torch.data.pipeline import BatchLoader
        sn = cfg.descriptor.surface_normal_len
        name = cfg.data.dataset
        if name == "oxford":
            ds = dl.OxfordDescriptorDataset(cfg.data, "train", sn_len=sn)

            def mine(raw):
                return ds.mine_negative_indices(np.asarray(raw["index"]))
        elif name == "kitti":
            ds = dl.KittiDescriptorDataset(cfg.data, "train", sn_len=sn)

            def mine(raw):
                return ds.mine_negative_indices(np.asarray(raw["seq"]),
                                                np.asarray(raw["pose"]))
        else:
            raise SystemExit(
                f"descriptor training on {name!r} is not ported (oxford and "
                "kitti are; the reference trains descriptors on oxford, "
                "kitti and scenenn)")
        loader = BatchLoader(ds, cfg.train.batch_size, shuffle=True,
                             num_workers=cfg.data.num_workers)
        test_loader = None
        try:
            test_loader = BatchLoader(
                type(ds)(cfg.data, "test", sn_len=sn), cfg.train.batch_size,
                shuffle=False, num_workers=cfg.data.num_workers)
        except (FileNotFoundError, OSError):
            pass  # no test split on disk
        engine = DescriptorEngine(cfg, args.detector_checkpoint,
                                  train_loader=loader,
                                  test_loader=test_loader,
                                  mine_negatives=mine, device=args.device)
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


def cmd_export_descriptors(args):
    """Keypoints and their descriptors of the eval frames, as
    ``<out>/keypoints`` and ``<out>/descriptors`` .bin trees; the
    descriptor-role config, as the checkpoints were trained under it."""
    cfg = _build_config(args, role="descriptor")
    from usip_tpu_torch.eval.export_runner import run_export_with_descriptors
    stats = run_export_with_descriptors(
        cfg, detector_checkpoint=args.checkpoint,
        descriptor_checkpoint=args.descriptor_checkpoint,
        kp_out=os.path.join(args.out, "keypoints"),
        desc_out=os.path.join(args.out, "descriptors"),
        nms_radius=args.nms_radius, desired_num=args.num_keypoints,
        synthetic=args.synthetic, device=args.device)
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


def cmd_eval_registration(args):
    """RANSAC registration of the GT pairs from exported keypoints and
    descriptors: one JSON line of ``RegistrationStats``, or one per RANSAC
    budget with ``--sweep-trials`` (automation_kitti.m:4-19)."""
    from usip_tpu_torch.eval.eval_runner import make_coord_fix, run_registration
    gt = _load_gt(args)
    fix = make_coord_fix(args.coord_fix, args.calib_root)
    budgets = ([int(t) for t in args.sweep_trials.split(",")]
               if args.sweep_trials else [args.max_trials])
    for trials in budgets:
        stats = run_registration(args.kp_dir, args.desc_dir, gt,
                                 desc_dim=args.desc_dim,
                                 threshold=args.inlier_threshold,
                                 max_trials=trials, coord_fix=fix)
        line = stats._asdict()
        if args.sweep_trials:
            line = {"max_trials": trials, **line}
        print(json.dumps(line), flush=True)


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
    p.add_argument("--descriptor-checkpoint", default=None,
                   help="also describe the keypoints (<name>.desc.bin): the "
                        "port's .pt, a usip_tpu .msgpack or a reference "
                        ".pth")
    p.add_argument("--num-keypoints", type=int, default=128)
    p.add_argument("--nms-radius", type=float, default=0.0)


def _add_gt_flags(p):
    p.add_argument("--gt-dir", default=None)
    p.add_argument("--kitti-gt", default=None,
                   help="kitti-reg-test root with <seq>/groundtruths.txt")
    p.add_argument("--oxford-root", default=None,
                   help="oxford dataroot (reads test groundtruths.pkl)")
    p.add_argument("--coord-fix", default="none",
                   choices=["none", "kitti", "oxford"],
                   help="convert exported camera-frame keypoints into the GT "
                        "frame (eval_rep.m:48,70-83)")
    p.add_argument("--calib-root", default=None,
                   help="kitti calib tree <root>/<seq:02d>/calib.txt")


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

    p = sub.add_parser("train-descriptor")
    _add_run_flags(p)
    p.add_argument("--detector-checkpoint", required=True,
                   help="the frozen detector (.pt or usip_tpu .msgpack)")
    p.add_argument("--resume", default=None,
                   help="descriptor checkpoint path, or 'auto' for "
                        "<out_dir>/last.pt")
    p.set_defaults(fn=cmd_train_descriptor)

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

    p = sub.add_parser("export-descriptors")
    _add_run_flags(p)
    p.add_argument("--checkpoint", required=True, help="detector checkpoint")
    p.add_argument("--descriptor-checkpoint", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--nms-radius", type=float, default=0.0)
    p.add_argument("--num-keypoints", type=int, default=128)
    p.set_defaults(fn=cmd_export_descriptors)

    p = sub.add_parser("eval-repeatability")
    p.add_argument("--anc-dir", required=True)
    p.add_argument("--pos-dir", required=True)
    p.add_argument("--inlier-radius", type=float, default=0.5)
    _add_gt_flags(p)
    p.set_defaults(fn=cmd_eval_repeatability)

    p = sub.add_parser("eval-registration")
    p.add_argument("--kp-dir", required=True)
    p.add_argument("--desc-dir", required=True)
    p.add_argument("--desc-dim", type=int, default=128)
    p.add_argument("--inlier-threshold", type=float, default=1.0)
    p.add_argument("--max-trials", type=int, default=10000)
    p.add_argument("--sweep-trials", default=None,
                   help="comma list of RANSAC budgets (automation_kitti.m "
                        "sweep)")
    _add_gt_flags(p)
    p.set_defaults(fn=cmd_eval_registration)

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
