"""The indoor protocol through the port (counterpart of
``scripts/fullscale_indoor.py``): the lite detector and the global-context
descriptor (CGF loss) trained at the scenenn preset on a synthetic SceneNN
tree, then 3DMatch-style fragment registration -> recall/precision through
``eval/indoor.py`` (the ElasticReconstruction lite protocol,
eval_indoor/fullEvaluation.m:1-12 + 3dmatch/register2Fragments.m).

Phases (run separately so the long trains can sit in the background):

  python -m usip_tpu_torch.indoor gen        [--root R]
  python -m usip_tpu_torch.indoor train-det  [--root R] [--device cuda]
  python -m usip_tpu_torch.indoor train-desc [--root R] [--device cuda]
  python -m usip_tpu_torch.indoor eval       [--root R] [--device cuda]

``eval`` exports per-fragment keypoint+descriptor features (trained AND
untrained, seed 321, descriptor on the same trained keypoints), registers
the gt-overlapped fragment pairs per scene, and prints one JSON line with
recall/precision for both arms (reference bar: evaluate.m:42-43).

The diagnostics of the indoor cells (scripts/diag_indoor.py,
scripts/eval_indoor_arm.py, scripts/probe_desc_selection.py: their flags
and JSON keys):

  python -m usip_tpu_torch.indoor diag [--root R] [--tag trained]
  python -m usip_tpu_torch.indoor eval-arm --desc-ckpt D.pt --tag T
  python -m usip_tpu_torch.indoor probe-selection [--epochs 60]

``diag`` separates keypoint geometry from descriptor quality on an
exported feature tree (host numpy only); ``eval-arm`` scores one
descriptor checkpoint under the eval's protocol without the untrained arm;
``probe-selection`` asks at toy size whether the CGF test loss and the
matching accuracy select different descriptor checkpoints.

The script's phases, defaults and JSON line, with the port's checkpoints
(``.pt``) and ``--device`` (default ``cuda``, which raises without CUDA) in
place of ``--platform``. The default root is ``synth_indoor`` under the
temporary directory (``TMPDIR``).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile


def _scenenn_root(root):
    return os.path.join(root, "scenenn")


def _m3d_root(root):
    return os.path.join(root, "match3d")


def _scene_names(root):
    return sorted(os.listdir(os.path.join(_m3d_root(root), "fragments")))


def _ckpt_dir(root):
    return os.path.join(root, "ckpt")


def phase_gen(args):
    from usip_tpu_torch.data.synthetic import (
        build_synthetic_match3d_fragments, build_synthetic_scenenn_tree)
    counts = build_synthetic_scenenn_tree(
        _scenenn_root(args.root), train_frames=args.frames,
        test_frames=max(args.frames // 3, 8), seed=0)
    frags = build_synthetic_match3d_fragments(
        _m3d_root(args.root), scenes=args.scenes,
        fragments_per_scene=args.fragments, seed=1)
    print(json.dumps({"phase": "gen", "root": args.root,
                      "scenenn": counts, "match3d": frags}), flush=True)


def _overrides(args):
    argv = []
    for kv in args.override:
        argv += ["--override", kv]
    return argv


def phase_train_det(args):
    """Lite detector at the scenenn preset (reference scenenn/
    train_detector.py and the indoor RPN_DetectorLite selection,
    keypoint_detector.py:19-22)."""
    from usip_tpu_torch.cli import main as cli_main
    cli_main(["train-detector", "--dataset", "scenenn", "--lite",
              "--dataroot", _scenenn_root(args.root),
              "--name", "indoor", "--epochs", str(args.epochs),
              "--checkpoints-dir", _ckpt_dir(args.root),
              "--override", "train.log_every=10", "--device", args.device]
             + _overrides(args))


def _best_or_last(folder):
    ckpt = os.path.join(folder, "best.pt")
    return ckpt if os.path.exists(ckpt) else os.path.join(folder, "last.pt")


def _det_ckpt(root):
    return _best_or_last(os.path.join(_ckpt_dir(root), "indoor"))


def phase_train_desc(args):
    """Indoor descriptor: global-context widths and the CGF loss on the
    frozen lite detector (scenenn/train_descriptor.py)."""
    from usip_tpu_torch.cli import main as cli_main
    cli_main(["train-descriptor", "--dataset", "scenenn",
              "--dataroot", _scenenn_root(args.root),
              "--name", "indoor", "--epochs", str(args.epochs),
              "--checkpoints-dir", _ckpt_dir(args.root),
              "--detector-checkpoint", _det_ckpt(args.root),
              "--override", "train.log_every=10", "--device", args.device]
             + _overrides(args))


def _parse_overrides(args):
    out = {}
    for kv in args.override:
        k, v = kv.split("=", 1)
        try:
            out[k] = json.loads(v)
        except json.JSONDecodeError:
            out[k] = v
    return out


def eval_arm(cfg, root, det_ckpt, desc_ckpt, tag, scenes, max_trials,
             desired, device):
    """Export the fragments' features with ``desc_ckpt`` into
    ``<root>/features_<tag>``, register each scene's gt pairs into
    ``<root>/logs_<tag>/<scene>.log`` (the lite protocol's overlapped pairs
    only, fullEvaluation.m:6), and score them."""
    from usip_tpu_torch.cli import register_scenes
    from usip_tpu_torch.eval import indoor
    from usip_tpu_torch.eval.export_runner import run_export_fragments

    pc_root = os.path.join(_m3d_root(root), "fragments")
    gt_root = os.path.join(_m3d_root(root), "gt")
    result_root = os.path.join(root, f"features_{tag}")
    stats = run_export_fragments(cfg, det_ckpt, desc_ckpt, pc_root,
                                 result_root, scenes, desired_num=desired,
                                 device=device)
    logs = register_scenes(pc_root, result_root, gt_root, scenes,
                           os.path.join(root, f"logs_{tag}"),
                           cfg.descriptor.descriptor_len, max_trials,
                           overlapped_only=True)
    per_scene = indoor.evaluate_scenes(logs, gt_root)
    return {"frames": stats["frames"],
            "per_scene": {s: r._asdict() for s, r in per_scene.items()},
            **indoor.summarize(per_scene)}


def phase_eval(args):
    from usip_tpu_torch.train.checkpoint import save_checkpoint
    from usip_tpu_torch.train.descriptor_loop import init_descriptor_state

    cfg = _indoor_eval_cfg(args)

    det_ckpt = _det_ckpt(args.root)
    desc_ckpt = _best_or_last(os.path.join(_ckpt_dir(args.root),
                                           "indoor_descriptor"))
    scenes = _scene_names(args.root)

    results = {"phase": "eval", "scenes": scenes}
    results["trained_desc"] = eval_arm(
        cfg, args.root, det_ckpt, desc_ckpt, "trained", scenes,
        args.max_trials, args.num_keypoints, args.device)

    upath = os.path.join(_ckpt_dir(args.root), "untrained_desc.pt")
    save_checkpoint(upath, init_descriptor_state(cfg, seed=321))
    results["untrained_desc"] = eval_arm(
        cfg, args.root, det_ckpt, upath, "untrained", scenes,
        args.max_trials, args.num_keypoints, args.device)
    print(json.dumps(results), flush=True)
    return results


def phase_diag(args):
    """Per gt pair of each scene: keypoint repeatability (the share of
    fragment i's keypoints whose gt-aligned nearest keypoint of fragment j
    lies within ``--radius``) and registration with oracle descriptors (the
    gt-aligned keypoint coordinates, tiled to 6 dims): high oracle recall
    means the keypoints support the protocol and the descriptors are the
    gap; ~0 means the keypoints do not repeat. Host numpy; one JSON line."""
    import numpy as np

    from usip_tpu_torch.eval import indoor

    frag_root = os.path.join(_m3d_root(args.root), "fragments")
    gt_root = os.path.join(_m3d_root(args.root), "gt")
    feat_root = os.path.join(args.root, f"features_{args.tag}")
    out = {"tag": args.tag, "scenes": {}}
    for scene in sorted(os.listdir(frag_root)):
        pc_dir = os.path.join(frag_root, scene)
        n_frag = len([f for f in os.listdir(pc_dir) if f.endswith(".npy")])
        frags = []
        for i in range(n_frag):
            pc = np.load(os.path.join(pc_dir, f"{i}.npy"))
            kp, desc = indoor.load_fragment_features(
                os.path.join(feat_root, scene, f"{i}.bin"), args.desc_len)
            frags.append((pc, kp, desc))
        ev = os.path.join(gt_root, f"{scene}-evaluation")
        gt = indoor.load_log(os.path.join(ev, "gt.log"))
        gt_info = indoor.load_info(os.path.join(ev, "gt.info"))

        reps, oracle_entries = [], []
        for idx, e in enumerate(gt):
            pc1, kp1, _ = frags[e.i]
            pc2, kp2, _ = frags[e.j]
            kp2_in_1 = kp2 @ e.trans[:3, :3].T + e.trans[:3, 3]
            d2 = (np.sum(kp1 ** 2, 1)[:, None]
                  + np.sum(kp2_in_1 ** 2, 1)[None]
                  - 2 * kp1 @ kp2_in_1.T)
            nn = np.sqrt(np.maximum(d2.min(axis=1), 0))
            reps.append(float((nn < args.radius).mean()))
            od1 = np.tile(kp1, (1, 2))
            od2 = np.tile(kp2_in_1, (1, 2))
            reg = indoor.register_fragments(
                pc1, pc2, kp1, od1, kp2, od2,
                max_trials=args.max_trials, seed=idx)
            if reg.ratio_aligned[0] > 0.23 and reg.inlier_ratio > 0.025:
                oracle_entries.append(indoor.LogEntry(
                    e.i, e.j, n_frag, reg.trans, reg.num_inliers,
                    reg.inlier_ratio, reg.information))

        res = indoor.evaluate_scene(oracle_entries, gt, gt_info)
        out["scenes"][scene] = {
            "gt_pairs": len(gt),
            "kp_repeatability_mean": float(np.mean(reps)),
            "kp_repeatability_min": float(np.min(reps)),
            "oracle": res._asdict(),
        }
    print(json.dumps(out), flush=True)
    return out


def _indoor_eval_cfg(args):
    from usip_tpu_torch.config import get_config
    over = {"data.dataroot": _scenenn_root(args.root),
            "train.batch_size": 4, "train.name": "indoor_eval"}
    over.update(_parse_overrides(args))
    return get_config("scenenn", role="descriptor", **over)


def phase_eval_arm(args):
    """One descriptor checkpoint under the eval's protocol (its export,
    RANSAC, gates and scoring) without the untrained arm: one JSON line."""
    res = eval_arm(_indoor_eval_cfg(args), args.root, _det_ckpt(args.root),
                   args.desc_ckpt, args.tag, _scene_names(args.root),
                   args.max_trials, args.num_keypoints, args.device)
    out = {"phase": "eval_arm", "tag": args.tag,
           "desc_ckpt": args.desc_ckpt, **res}
    print(json.dumps(out), flush=True)
    return out


def external_yaw_accuracy(cfg, det, descriptor, n_shapes, seed, radius=0.3):
    """The validate_descriptor --test-yaw protocol: per keypoint, 1-NN
    matching accuracy between a synthetic shape (seed ``seed``) and its
    yaw-rotated second sampling (numpy seed ``seed + 1``); the detector's
    node draws seeded ``2i``, ``2i + 1``, the descriptor's balls ``100 + i``,
    ``200 + i``."""
    import numpy as np
    import torch

    from usip_tpu_torch.data.augment import rotation_matrix
    from usip_tpu_torch.data.synthetic import SyntheticDataset
    from usip_tpu_torch.ops import sample_nodes
    from usip_tpu_torch.quality import match_accuracy

    det, descriptor = det.eval(), descriptor.eval()
    dev = next(det.parameters()).device
    ratio = (cfg.data.eval_fps_subsample_ratio
             or cfg.data.fps_subsample_ratio)
    gen = lambda s: torch.Generator(device=dev).manual_seed(s)  # noqa: E731
    to = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a[None], np.float32)).to(dev)
    ds = SyntheticDataset(size=n_shapes, input_pc_num=cfg.data.input_pc_num,
                          surface_normal_len=3, seed=seed)
    rng = np.random.default_rng(seed + 1)
    accs = []
    with torch.no_grad():
        for i in range(n_shapes):
            item = ds[i]
            pc, sn = item["src_pc"], item["src_sn"]
            ang = rng.uniform(0, 2 * np.pi)
            R = rotation_matrix(torch.tensor([0.0, ang, 0.0])).numpy()
            pc_r, sn_r = item["dst_pc"] @ R.T, item["dst_sn"] @ R.T
            kps = []
            for j, (p, s) in enumerate(((pc, sn), (pc_r, sn_r))):
                node = sample_nodes(to(p), cfg.data.node_num, ratio,
                                    cfg.data.fps_parallel,
                                    generator=gen(2 * i + j))
                kps.append(det(to(p), to(s), node)[1])
            da, dp = (descriptor(to(p), to(s), kp, generator=gen(g))[0][0]
                      .cpu().numpy()
                      for p, s, kp, g in ((pc, sn, kps[0], 100 + i),
                                          (pc_r, sn_r, kps[1], 200 + i)))
            ka, kpn = (k[0].cpu().numpy() for k in kps)
            accs.append(match_accuracy(ka, da, kpn, dp, R, radius))
    return float(np.mean(accs))


def phase_probe_selection(args):
    """Does the CGF test loss part from matching quality at long training,
    and does ``train.select_best_by='match_acc'`` pick a better checkpoint?
    A toy replica of the full-scale indoor divergence: a tiny detector,
    then a CGF descriptor for ``--epochs`` with a checkpoint an epoch, the
    held-out (loss, match_acc) curve, and the checkpoints selected by each
    scored under the external yaw-matching protocol. One JSON line."""
    from usip_tpu_torch.config import get_config
    from usip_tpu_torch.data.pipeline import BatchLoader
    from usip_tpu_torch.data.synthetic import SyntheticDataset
    from usip_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                 save_checkpoint)
    from usip_tpu_torch.train.descriptor_loop import (DescriptorEngine,
                                                      _SyntheticPairDataset,
                                                      init_descriptor_state)
    from usip_tpu_torch.train.loop import DetectorEngine

    cfg = get_config("modelnet", **{
        "data.input_pc_num": 256, "data.node_num": 32,
        "detector.c1": 32, "detector.c2": 64, "detector.node_knn_k": 4,
        "descriptor.descriptor_len": 32, "descriptor.ball_nsamples": 16,
        "descriptor.ball_radius": 0.5, "descriptor.surface_normal_len": 3,
        "train.batch_size": 16, "train.log_every": 1000})
    cfg_desc = cfg.with_overrides(**{
        "loss.cgf_radius": 0.3, "augment.rot_3d": False,
        "augment.rot_horizontal": True,
        "augment.gt_scale_thre": 0.0, "augment.gt_shift_thre": 0.0,
        "train.keep_epoch_checkpoints": True})

    train_ds = SyntheticDataset(size=args.size, input_pc_num=256,
                                surface_normal_len=3, seed=0)
    train = BatchLoader(train_ds, 16, num_workers=2, seed=0)
    det = DetectorEngine(cfg, train, None,
                         out_dir=os.path.join(args.out, "det"),
                         device=args.device)
    for ep in range(args.det_epochs):
        det.train_epoch(ep)
    det_ckpt = os.path.join(args.out, "det.pt")
    save_checkpoint(det_ckpt, det.state)

    desc_train = BatchLoader(_SyntheticPairDataset(cfg_desc, size=args.size,
                                                   seed=0),
                             16, num_workers=2, seed=0)
    # held-out shapes; the eval step applies its own device-side SE3 per the
    # CGF protocol, so this is a fresh-data test split
    desc_test = BatchLoader(_SyntheticPairDataset(cfg_desc, size=32, seed=9),
                            16, shuffle=False, num_workers=2, seed=1)
    eng = DescriptorEngine(cfg_desc, det_ckpt, train_loader=desc_train,
                           test_loader=desc_test, use_cgf=True,
                           out_dir=os.path.join(args.out, "desc"),
                           device=args.device)
    curve = []
    for ep in range(args.epochs):
        eng.train_epoch(ep)
        t = eng.test_epoch(ep)
        curve.append({"epoch": ep, "loss": t["loss"],
                      "match_acc": t["match_acc"]})
        save_checkpoint(os.path.join(eng.out_dir, f"epoch_{ep}.pt"),
                        eng.state, metadata={"epoch": ep, **t})

    by_loss = min(curve, key=lambda c: c["loss"])
    by_acc = max(curve, key=lambda c: c["match_acc"])

    def load_model(ep):
        state = init_descriptor_state(cfg_desc, 0, eng.device)
        restore_checkpoint(os.path.join(eng.out_dir, f"epoch_{ep}.pt"),
                           state)
        return state.model

    ext = {}
    for tag, sel in (("by_loss", by_loss), ("by_match_acc", by_acc)):
        ext[tag] = {"epoch": sel["epoch"], "test_loss": sel["loss"],
                    "test_match_acc": sel["match_acc"],
                    "external_yaw_acc": external_yaw_accuracy(
                        cfg, det.state.model, load_model(sel["epoch"]),
                        n_shapes=16, seed=77)}
    out = {"probe": "desc_selection", "epochs": args.epochs,
           "curve": curve, "selected": ext}
    print(json.dumps(out), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="usip_tpu_torch.indoor")
    sub = ap.add_subparsers(dest="phase", required=True)
    g = sub.add_parser("gen")
    g.add_argument("--frames", type=int, default=48)
    g.add_argument("--scenes", type=int, default=2)
    # 16 views around the ring: skip-2/skip-3 pairs still overlap >30%, so
    # the eval's non-adjacent (j-i>1) recall set is populated (a ring of 8
    # leaves almost only adjacent gt pairs, which evaluate_scene excludes
    # per mrEvaluateRegistrationMy.m)
    g.add_argument("--fragments", type=int, default=16)
    g.set_defaults(fn=phase_gen)
    td = sub.add_parser("train-det")
    td.add_argument("--epochs", type=int, default=40)
    td.set_defaults(fn=phase_train_det)
    tc = sub.add_parser("train-desc")
    tc.add_argument("--epochs", type=int, default=30)
    tc.set_defaults(fn=phase_train_desc)
    e = sub.add_parser("eval")
    e.add_argument("--max-trials", type=int, default=1000)
    # export every SOM proposal (scenenn node_num=512, options_detector.py:34)
    # — at room scale 256 keypoints leave the gt-aligned NN spacing above the
    # 0.2 m inlier threshold, capping RANSAC below the writeLog gates
    e.add_argument("--num-keypoints", type=int, default=512)
    e.set_defaults(fn=phase_eval)
    d = sub.add_parser("diag")
    d.add_argument("--tag", default="trained")
    d.add_argument("--desc-len", type=int, default=128)
    d.add_argument("--radius", type=float, default=0.2)
    d.add_argument("--max-trials", type=int, default=1000)
    d.set_defaults(fn=phase_diag)
    a = sub.add_parser("eval-arm")
    a.add_argument("--desc-ckpt", required=True,
                   help="descriptor checkpoint (.pt, or a usip_tpu "
                        ".msgpack) to evaluate")
    a.add_argument("--tag", required=True,
                   help="output tag: features_<tag>/ logs_<tag>/")
    a.add_argument("--max-trials", type=int, default=1000)
    a.add_argument("--num-keypoints", type=int, default=512)
    a.set_defaults(fn=phase_eval_arm)
    s = sub.add_parser("probe-selection")
    s.add_argument("--epochs", type=int, default=60)
    s.add_argument("--det-epochs", type=int, default=8)
    s.add_argument("--size", type=int, default=128)
    s.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                 "desc_selection_probe"))
    s.set_defaults(fn=phase_probe_selection)
    root = os.path.join(tempfile.gettempdir(), "synth_indoor")
    for p in (g, td, tc, e, d, a):
        p.add_argument("--root", default=root)
    for p in (g, td, tc, e, a, s):
        p.add_argument("--device", default="cuda",
                       help="torch device; 'cuda' fails when CUDA is absent")
    for p in (g, td, tc, e, a):
        p.add_argument("--override", action="append", default=[],
                       help="dotted config override (repeatable; lets the "
                            "protocol run at reduced scale for CPU smoke)")
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
