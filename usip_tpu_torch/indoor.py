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
    from usip_tpu_torch.config import get_config
    from usip_tpu_torch.train.checkpoint import save_checkpoint
    from usip_tpu_torch.train.descriptor_loop import init_descriptor_state

    over = {"data.dataroot": _scenenn_root(args.root),
            "train.batch_size": 4, "train.name": "indoor_eval"}
    over.update(_parse_overrides(args))
    cfg = get_config("scenenn", role="descriptor", **over)

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
    for p in (g, td, tc, e):
        p.add_argument("--root", default=os.path.join(tempfile.gettempdir(),
                                                      "synth_indoor"))
        p.add_argument("--device", default="cuda",
                       help="torch device; 'cuda' fails when CUDA is absent")
        p.add_argument("--override", action="append", default=[],
                       help="dotted config override (repeatable; lets the "
                            "protocol run at reduced scale for CPU smoke)")
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
