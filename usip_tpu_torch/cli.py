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
  python -m usip_tpu_torch.cli eval-indoor --gt-root TREE/gt \
      --pc-root TREE/fragments --result-root feats/ --scenes s0,s1 \
      --out logs/ [--estimator ransac|fgr] [--overlapped-only]
  python -m usip_tpu_torch.cli bench [--device cuda]
  python -m usip_tpu_torch.cli detect --input clouds/ --checkpoint w.pth \
      --out served/ [--descriptor-checkpoint d.pt] [--device cuda] \
      [--render] [--html]
  python -m usip_tpu_torch.cli render-keypoints --dataset kitti \
      --dataroot TREE --kp-dir kp/ --out gallery/ [--kp-dim 4]
  python -m usip_tpu_torch.cli serve --checkpoint w.pth \
      [--descriptor-checkpoint d.pt] [--device cuda]
  python -m usip_tpu_torch.cli serve --dataset oxford \
      --override detector.grouping=ball --checkpoint w.pth
  python -m usip_tpu_torch.cli export-model --checkpoint w.pth \
      --out det.usipart [--descriptor-checkpoint d.pt [--pipeline]] \
      [--batch 8] [--platforms cuda,cpu]
  python -m usip_tpu_torch.cli run-model --artifact det.usipart \
      --input clouds/ --out served/ [--desc-artifact d.usipart] [--device cuda]
  python -m usip_tpu_torch.cli import-torch --pth 100_net_detector.pth \
      --out imported.pt [--role descriptor]

The flags and the request and reply protocol are ``usip_tpu.cli``'s, plus
``--device`` (default ``cuda``, which raises without CUDA rather than run on
the CPU). ``render-keypoints`` and ``detect --render``/``--html`` draw with
matplotlib, imported when a scene is drawn; without it they raise its
``ImportError``, as usip_tpu's do. ``run-model`` loads no model code and
no config: the artifact holds the program.

Several ranks (``train-detector``, ``train-descriptor``, ``export-keypoints``,
``export-descriptors``): ``--num-devices N`` on one host starts N ranks
itself, one GPU each (``cuda:LOCAL_RANK``, modulo the visible cards), and
``--batch-size`` is the global batch. Under torchrun the command joins
torchrun's group instead (``--num-devices``, if given, must be its size).
``--coordinator-address host:port --num-processes P --process-id I`` is
usip_tpu's multi-host form: each of P hosts runs the command with its
``--num-devices`` local ranks, and ``--batch-size`` is per host.
``--dist-backend`` (default NCCL on CUDA, gloo on the CPU) takes ``gloo`` for
ranks that share one GPU. A failed init raises: a run that asks for several
ranks never carries on as one. A checkpoint is the port's own ``.pt`` (what ``train-detector``
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
    from usip_tpu_torch.config import get_config
    overrides = _parse_overrides(args.override)
    cfg = get_config(args.dataset, role=role, **overrides)
    updates = {key: getattr(args, flag) for flag, key in (
        ("dataroot", "data.dataroot"), ("num_devices", "train.num_devices"),
        ("name", "train.name"), ("checkpoints_dir", "train.checkpoint_dir"))
        if getattr(args, flag, None) is not None}
    if getattr(args, "batch_size", None):
        updates["train.batch_size"] = args.batch_size
    hosts = getattr(args, "hosts", 1)
    if hosts > 1:
        # multi-host: --batch-size (or the preset's) is per host
        updates["train.batch_size"] = hosts * updates.get(
            "train.batch_size", cfg.train.batch_size)
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


def _detect_one(pipe, args, data, s, out_dir, name, nk, nms, render=False):
    """Keypoints (and descriptors) of one cloud written to ``out_dir``:
    ``{"keypoints": path, "descriptors": path?, "n": count}``; with
    ``render``, also the keypoint scene ``<name>.png`` (keypoints shaded by
    sigma, unshaded with a descriptor, as in usip_tpu)."""
    pc, sn = data[:, :3], _sn_columns(data, s)
    reply, sig = {}, None
    if args.descriptor_checkpoint:
        kp, desc = pipe.detect_and_describe(pc, sn, num_keypoints=nk,
                                            nms_radius=nms)
        dpath = os.path.join(out_dir, f"{name}.desc.bin")
        desc.astype(np.float32).tofile(dpath)
        reply["descriptors"] = dpath
    else:
        kp, sig = pipe.detect(pc, sn, num_keypoints=nk, nms_radius=nms)
    kpath = os.path.join(out_dir, f"{name}.keypoints.bin")
    kp.astype(np.float32).tofile(kpath)
    if render:
        # the working replacement of the reference's broken matplotlib
        # keypoint viewer (oxford/test.py:6,17) and of the visdom scatter
        # payloads (models/keypoint_detector.py:259-334)
        from usip_tpu_torch.utils.vis import save_keypoint_scene
        save_keypoint_scene(os.path.join(out_dir, f"{name}.png"), pc, None,
                            kp, sig)
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
    gallery = None
    if args.html:
        from usip_tpu_torch.utils.html import HTMLGallery
        # image_dir='' -> renders live next to index.html, links stay valid
        gallery = HTMLGallery(args.out, title="usip_tpu detections",
                              image_dir="")
    s = cfg.detector.surface_normal_len
    for path in paths:
        name = os.path.splitext(os.path.basename(path))[0]
        reply = _detect_one(pipe, args, np.load(path), s, args.out, name,
                            args.num_keypoints, args.nms_radius,
                            render=args.render or gallery is not None)
        if gallery is not None:
            gallery.add_section(name, [(f"{name}.png",
                                        f"{reply['n']} keypoints")])
        print(f"{name}: {reply['n']} keypoints", flush=True)
    if gallery is not None:
        gallery.save()
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
                        num_workers=cfg.data.num_workers, shard=_shard(cfg))
    test = BatchLoader(test_ds, cfg.train.batch_size, shuffle=False,
                       num_workers=cfg.data.num_workers, shard=_shard(cfg))
    return train, test


def _shard(cfg):
    """``(rank, ranks)`` of a data-parallel run (each rank loads its rows
    of the global batch), else None."""
    if cfg.train.num_devices <= 1:
        return None
    from usip_tpu_torch.parallel.mesh import global_rank
    return global_rank(), cfg.train.num_devices


def _print_main(line: str) -> None:
    """Print on rank 0 only (every rank holds the same result)."""
    from usip_tpu_torch.parallel.mesh import is_main_process
    if is_main_process():
        print(line, flush=True)


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
        _print_main(f"resumed from {path} at epoch {start}")
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
        elif name == "scenenn":
            ds = dl.SceneNNDescriptorDataset(cfg.data, "train", sn_len=sn)
            mine = None  # the CGF loss mines per keypoint on the device
        else:
            raise SystemExit(f"descriptor training not defined for {name!r} "
                             "(the reference trains descriptors on oxford, "
                             "kitti and scenenn only)")
        loader = BatchLoader(ds, cfg.train.batch_size, shuffle=True,
                             num_workers=cfg.data.num_workers,
                             shard=_shard(cfg))
        test_loader = None
        try:
            test_loader = BatchLoader(
                type(ds)(cfg.data, "test", sn_len=sn), cfg.train.batch_size,
                shuffle=False, num_workers=cfg.data.num_workers,
                shard=_shard(cfg))
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
        _print_main(f"resumed from {path} at epoch {start}")
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
                       with_sigmas=args.with_sigmas, device=args.device,
                       subset=args.subset)
    _print_main(json.dumps(stats))


def cmd_render_keypoints(args):
    """Browse exported keypoints over their clouds (the reference's
    evaluation/visualize_keypoints viewer); host code, needs matplotlib."""
    cfg = _build_config(args)
    from usip_tpu_torch.eval.render import run_render
    stats = run_render(cfg, kp_dir=args.kp_dir, out_dir=args.out,
                       kp_dim=args.kp_dim,
                       sigma_threshold=args.sigma_threshold,
                       max_frames=args.max_frames, html=not args.no_html,
                       seed=args.seed, synthetic=args.synthetic,
                       subset=args.subset)
    print(json.dumps(stats))


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
    _print_main(json.dumps(stats))


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


def register_scenes(pc_root, result_root, gt_root, scenes, out,
                    desc_dim=128, max_trials=1000, estimator="ransac",
                    overlapped_only=False):
    """Register each scene's fragment pairs (all, or the gt-overlapped ones)
    from ``<result_root>/<scene>/<i>.bin`` features into
    ``<out>/<scene>.log``; returns ``{scene: log path}``."""
    from usip_tpu_torch.eval import indoor
    os.makedirs(out, exist_ok=True)
    logs = {}
    for scene in scenes:
        pc_dir = os.path.join(pc_root, scene)
        n_frag = len([f for f in os.listdir(pc_dir) if f.endswith(".npy")])
        fragments = []
        for i in range(n_frag):
            pc = np.load(os.path.join(pc_dir, f"{i}.npy"))
            kp, desc = indoor.load_fragment_features(
                os.path.join(result_root, scene, f"{i}.bin"), desc_dim)
            fragments.append((pc, kp, desc))
        pairs = None
        if overlapped_only:
            gt = indoor.load_log(os.path.join(
                gt_root, f"{scene}-evaluation", "gt.log"))
            pairs = [(e.i, e.j) for e in gt]
        entries = indoor.run_scene_registration(
            fragments, pairs=pairs, max_trials=max_trials,
            estimator=estimator)
        logs[scene] = os.path.join(out, f"{scene}.log")
        indoor.write_log_my(logs[scene], entries)
    return logs


def cmd_eval_indoor(args):
    """3DMatch/Redwood fragment-registration eval (the ElasticReconstruction
    lite protocol, eval_indoor/fullEvaluation.m): register the gated pairs
    of each scene into ``<out>/<scene>.log``, then recall and precision
    against the ground truth, one JSON line a scene and one for the mean.
    With ``--logs-only``, evaluates existing logs (the Redwood loop
    protocol, eval_loop.m)."""
    from usip_tpu_torch.eval import indoor
    scenes = args.scenes.split(",")
    if args.logs_only:
        if not args.log_dir:
            raise SystemExit("eval-indoor: --logs-only requires --log-dir")
        logs = {scene: os.path.join(args.log_dir, f"{scene}.log")
                for scene in scenes}
    else:
        missing = [f for f, v in (("--pc-root", args.pc_root),
                                  ("--result-root", args.result_root),
                                  ("--out", args.out)) if not v]
        if missing:
            raise SystemExit(
                f"eval-indoor: register mode requires {' '.join(missing)} "
                "(or pass --logs-only with --log-dir)")
        logs = register_scenes(args.pc_root, args.result_root, args.gt_root,
                               scenes, args.out, args.desc_dim,
                               args.max_trials, args.estimator,
                               args.overlapped_only)
    per_scene = indoor.evaluate_scenes(logs, args.gt_root)
    for scene, r in per_scene.items():
        print(json.dumps({"scene": scene, **r._asdict()}), flush=True)
    print(json.dumps(indoor.summarize(per_scene)), flush=True)


def cmd_bench(args):
    from usip_tpu_torch.bench import main as bench_main
    bench_main(["--device", args.device])


def cmd_export_model(args):
    """Write self-contained model artifacts (``torch.export`` programs with
    the weights baked in, one a platform): the deployment form, run without
    model code by ``run-model``."""
    from usip_tpu_torch.model_artifact import (export_descriptor_artifact,
                                               export_detector_artifact,
                                               export_pipeline_artifact)
    platforms = tuple(p.strip() for p in args.platforms.split(","))
    cfg = _build_config(
        args, role="descriptor" if args.descriptor_checkpoint else "detector")
    if args.pipeline:
        if not args.descriptor_checkpoint:
            raise SystemExit("--pipeline needs --descriptor-checkpoint "
                             "(it fuses detect+describe into one program)")
        hdr = export_pipeline_artifact(
            cfg, args.checkpoint, args.descriptor_checkpoint, args.out,
            batch=args.batch, platforms=platforms)
        hdr["path"] = args.out
        print(json.dumps({"pipeline": hdr}))
        return
    out = {}
    out["detector"] = export_detector_artifact(
        cfg, args.checkpoint, args.out, batch=args.batch, platforms=platforms)
    out["detector"]["path"] = args.out
    if args.descriptor_checkpoint:
        desc_out = args.desc_out or (os.path.splitext(args.out)[0]
                                     + ".descriptor.usipart")
        out["descriptor"] = export_descriptor_artifact(
            cfg, args.descriptor_checkpoint, desc_out, batch=args.batch,
            num_keypoints=args.num_keypoints, platforms=platforms)
        out["descriptor"]["path"] = desc_out
    print(json.dumps(out))


def cmd_run_model(args):
    """Serve raw .npy clouds through exported artifacts (the checkpoint-free
    counterpart of ``detect``)."""
    from usip_tpu_torch.model_artifact import run_detector_artifact
    paths = sorted(globmod.glob(os.path.join(args.input, "*.npy"))
                   if os.path.isdir(args.input) else globmod.glob(args.input))
    if not paths:
        raise SystemExit(f"no .npy clouds match {args.input}")
    stats = run_detector_artifact(
        args.artifact, paths, args.out, num_keypoints=args.num_keypoints,
        nms_radius=args.nms_radius, desc_artifact_path=args.desc_artifact,
        seed=args.seed, device=args.device)
    print(json.dumps(stats))


def cmd_import_torch(args):
    """Turn a reference PyTorch checkpoint (``<epoch>_net_detector.pth`` /
    ``_net_descriptor.pth``) into a full-state ``.pt`` (the model's
    ``state_dict`` loaded with ``strict=True``, a fresh Adam, step 0) that
    ``train-detector``/``train-descriptor --resume`` fine-tune from."""
    from usip_tpu_torch.train.checkpoint import save_checkpoint
    from usip_tpu_torch.train.state import TrainState
    from usip_tpu_torch.weights import load_detector_weights

    cfg = _build_config(args, role=args.role)
    if args.role == "detector":
        from usip_tpu_torch.models import Detector
        model = Detector(cfg.detector)
    else:
        from usip_tpu_torch.models import Descriptor
        model = Descriptor(cfg.descriptor)
    model.load_state_dict(load_detector_weights(args.pth), strict=True)
    save_checkpoint(args.out, TrainState.create(model, cfg.train.lr),
                    metadata={"imported_from": args.pth, "role": args.role})
    print(f"imported {args.pth} -> {args.out} ({args.role}, "
          f"dataset={cfg.data.dataset})")


def _add_preset_flags(p):
    p.add_argument("--dataset", default="kitti",
                   choices=["modelnet", "shrec", "oxford", "kitti", "scenenn",
                            "match3d"])
    p.add_argument("--override", action="append", default=[],
                   help="dotted config override, e.g. data.input_pc_num=4096")


def _add_config_flags(p):
    _add_preset_flags(p)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' fails when CUDA is absent")


def _add_run_flags(p):
    """usip_tpu's common train/export flags, its multi-host ones included,
    and ``--dist-backend``."""
    _add_config_flags(p)
    p.add_argument("--dataroot", default="")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--num-devices", type=int, default=None,
                   help="ranks (one device each) on this host; >1 starts "
                        "them (data parallel, --batch-size global)")
    p.add_argument("--coordinator-address", default=None,
                   help="multi-host: host:port of process 0's rendezvous")
    p.add_argument("--num-processes", type=int, default=None,
                   help="multi-host: number of hosts")
    p.add_argument("--process-id", type=int, default=None,
                   help="multi-host: this host's index")
    p.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                   help="collectives backend (default: nccl on cuda, gloo "
                        "on cpu; gloo for ranks sharing one GPU)")
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


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="usip_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("train-detector")
    _add_run_flags(p)
    p.add_argument("--resume", default=None,
                   help="checkpoint path (the port's .pt, or a usip_tpu "
                        ".msgpack, its Adam moments included), or 'auto' "
                        "for <out_dir>/last.pt")
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
    p.add_argument("--method", default="model",
                   choices=["model", "random", "iss", "harris", "sift"],
                   help="trained detector or a classical baseline "
                        "(save_keypoints.py method switch)")
    p.add_argument("--noise-sigma", type=float, default=0.0)
    p.add_argument("--downsample-rate", type=int, default=1,
                   help="detect on input_pc_num/rate points "
                        "(save_keypoints.py downsample_rate)")
    p.add_argument("--subset", default="original",
                   choices=["original", "rotated"],
                   help="modelnet/shrec: which half of the rotated-pair "
                        "repeatability protocol to export")
    p.add_argument("--with-sigmas", action="store_true",
                   help="write 4-column (xyz, sigma) bins")
    p.set_defaults(fn=cmd_export_keypoints)

    p = sub.add_parser("render-keypoints",
                       help="render exported keypoint .bin trees over their "
                            "source clouds (evaluation/visualize_keypoints "
                            "viewer): PNGs + an HTML gallery; needs "
                            "matplotlib")
    _add_preset_flags(p)
    p.add_argument("--dataroot", default="")
    p.add_argument("--synthetic", action="store_true",
                   help="render over the synthetic eval frames")
    p.add_argument("--kp-dir", required=True,
                   help="root of an export-keypoints .bin tree")
    p.add_argument("--out", required=True)
    p.add_argument("--kp-dim", type=int, default=3, choices=[3, 4],
                   help="columns per keypoint row (4 = --with-sigmas exports)")
    p.add_argument("--sigma-threshold", type=float, default=None,
                   help="keep keypoints with sigma < threshold (defaults to "
                        "the reference's per-dataset value for 4-column bins: "
                        "modelnet 0.04 / oxford 0.25 / kitti 0.3 / "
                        "scenenn 0.08, visualize_features.m)")
    p.add_argument("--max-frames", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-html", action="store_true")
    p.add_argument("--subset", default="original",
                   choices=["original", "rotated"],
                   help="modelnet/shrec: which half of the rotated-pair "
                        "tree the bins were exported from")
    p.set_defaults(fn=cmd_render_keypoints)

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

    p = sub.add_parser("eval-indoor")
    p.add_argument("--gt-root", required=True,
                   help="dir with <scene>-evaluation/gt.log+gt.info")
    p.add_argument("--scenes", default="livingroom1,livingroom2,office1,office2")
    p.add_argument("--pc-root", help="fragment npy tree <root>/<scene>/<i>.npy")
    p.add_argument("--result-root",
                   help="keypoint+descriptor bins <root>/<scene>/<i>.bin")
    p.add_argument("--out", default="indoor_logs",
                   help="where to write <scene>.log result logs")
    p.add_argument("--desc-dim", type=int, default=128)
    p.add_argument("--estimator", default="ransac", choices=["ransac", "fgr"],
                   help="pose estimator: RANSAC (register2Fragments.m) or "
                        "Fast Global Registration (register2FragmentsFGR.m)")
    p.add_argument("--max-trials", type=int, default=1000,
                   help="RANSAC cap (lite protocol, fullEvaluation.m:5)")
    p.add_argument("--overlapped-only", action="store_true",
                   help="register only gt-overlapped pairs (lite protocol)")
    p.add_argument("--logs-only", action="store_true",
                   help="skip registration; evaluate existing logs "
                        "(Redwood loop protocol)")
    p.add_argument("--log-dir", help="dir with <scene>.log for --logs-only")
    p.set_defaults(fn=cmd_eval_indoor)

    p = sub.add_parser("bench", help="detect throughput on the card: one "
                       "JSON line")
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("detect", help="keypoints for .npy cloud files")
    _add_common(p)
    p.add_argument("--input", required=True,
                   help="directory of .npy clouds, or a glob")
    p.add_argument("--out", required=True)
    p.add_argument("--render", action="store_true",
                   help="write a keypoint-scene PNG per cloud (needs "
                        "matplotlib)")
    p.add_argument("--html", action="store_true",
                   help="also build an index.html gallery of the renders")
    p.set_defaults(fn=cmd_detect)

    p = sub.add_parser("serve", help="resident keypoint service: JSON "
                       "requests on stdin, JSON replies on stdout")
    _add_common(p)
    p.add_argument("--out", default=None,
                   help="default output dir when requests omit 'out'")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("export-model",
                       help="write a self-contained artifact (torch.export "
                            "programs, weights baked in) for checkpoint-free "
                            "serving")
    _add_preset_flags(p)
    p.add_argument("--checkpoint", required=True, help="detector checkpoint")
    p.add_argument("--out", required=True, help="artifact path (.usipart)")
    p.add_argument("--batch", type=int, default=1,
                   help="pinned serving batch (static shapes)")
    p.add_argument("--platforms", default="cuda",
                   help="comma-separated devices the file holds a program "
                        "for: cuda, cpu")
    p.add_argument("--descriptor-checkpoint", default=None,
                   help="also export a descriptor artifact")
    p.add_argument("--desc-out", default=None,
                   help="descriptor artifact path (default: "
                        "<out>.descriptor.usipart)")
    p.add_argument("--num-keypoints", type=int, default=128,
                   help="keypoint-set shape pinned into the descriptor "
                        "artifact")
    p.add_argument("--pipeline", action="store_true",
                   help="one program (FPS+detect+describe, descriptors for "
                        "every proposal) instead of two artifacts")
    p.set_defaults(fn=cmd_export_model)

    p = sub.add_parser("run-model",
                       help="run exported artifacts over raw .npy clouds "
                            "(no model code or checkpoints needed)")
    p.add_argument("--artifact", required=True)
    p.add_argument("--input", required=True,
                   help=".npy file, glob, or directory of clouds")
    p.add_argument("--out", required=True)
    p.add_argument("--num-keypoints", type=int, default=128)
    p.add_argument("--nms-radius", type=float, default=0.0)
    p.add_argument("--desc-artifact", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' fails when CUDA is absent")
    p.set_defaults(fn=cmd_run_model)

    p = sub.add_parser("import-torch", help="convert a reference .pth "
                       "state_dict into a full-state checkpoint (.pt)")
    p.add_argument("--pth", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--role", default="detector",
                   choices=["detector", "descriptor"])
    _add_preset_flags(p)
    p.set_defaults(fn=cmd_import_torch)

    return parser


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if _launch_ranks(args, argv):
        return
    args.fn(args)


# ----------------------------------------------------- several ranks ----

def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _launch_ranks(args, argv) -> bool:
    """Start or join the ranks of a multi-rank run; True when the ranks ran
    here (this process only started them), False when the command runs in
    this process, as one rank or as the only process."""
    if not hasattr(args, "num_devices"):
        return False
    from usip_tpu_torch.parallel import mesh as pmesh
    local = args.num_devices or 1
    backend = args.dist_backend or pmesh.default_backend(args.device)
    if args.coordinator_address is not None:
        if args.num_processes is None or args.process_id is None:
            raise SystemExit("--coordinator-address needs --num-processes "
                             "and --process-id")
        hosts = args.num_processes
        spec = (args.coordinator_address, hosts * local,
                args.process_id * local, hosts)
    elif all(os.environ.get(k) for k in pmesh._TORCHRUN_ENV):
        world = int(os.environ["WORLD_SIZE"])
        if args.num_devices not in (None, world):
            raise SystemExit(f"--num-devices {args.num_devices}: torchrun "
                             f"started {world} ranks")
        pmesh.initialize_distributed(backend=backend, device=args.device)
        args.num_devices = world
        return False
    elif local > 1:
        spec = (f"127.0.0.1:{_free_port()}", local, 0, 1)
    else:
        return False
    if local == 1:
        _run_rank(0, argv, spec, backend)
        return True
    import torch.multiprocessing as mp
    mp.start_processes(_run_rank, args=(argv, spec, backend), nprocs=local,
                       start_method="spawn")
    return True


def _run_rank(local_rank: int, argv, spec, backend: str) -> None:
    """One rank of a run started by ``_launch_ranks``: join the group, run
    the command with ``train.num_devices`` the world size."""
    import torch.distributed as dist

    from usip_tpu_torch.parallel.mesh import initialize_distributed
    address, world, first_rank, hosts = spec
    os.environ["LOCAL_RANK"] = str(local_rank)
    args = build_parser().parse_args(argv)
    args.num_devices = world
    args.hosts = hosts
    initialize_distributed(address, world, first_rank + local_rank,
                           backend=backend, device=args.device)
    try:
        args.fn(args)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
