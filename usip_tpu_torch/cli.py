"""Command line of the port: the ``detect`` and ``serve`` subcommands.

  python -m usip_tpu_torch.cli detect --input clouds/ --checkpoint w.pth \
      --out served/ [--device cuda]
  python -m usip_tpu_torch.cli serve --checkpoint w.pth [--device cuda]
  python -m usip_tpu_torch.cli serve --dataset oxford \
      --override detector.grouping=ball --checkpoint w.pth

Same request and reply protocol as ``usip_tpu.cli``; the checkpoint is a
reference-named detector ``state_dict`` (``.pth``): the SOM family
(``first_pointnet.*``) under the presets as they are, the grouped family
(``conv1..5``, e.g. the released Oxford ball model) with
``detector.grouping=ball`` or ``knn``.
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


def _build_config(args):
    overrides = {}
    for ov in args.override:
        k, _, v = ov.partition("=")
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v
    return get_config(args.dataset, role="detector", **overrides)


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


def _add_common(p):
    p.add_argument("--dataset", default="kitti",
                   choices=["modelnet", "shrec", "oxford", "kitti", "scenenn",
                            "match3d"])
    p.add_argument("--override", action="append", default=[],
                   help="dotted config override, e.g. data.input_pc_num=4096")
    p.add_argument("--checkpoint", required=True,
                   help="reference-named detector state_dict (.pth)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' fails when CUDA is absent")
    p.add_argument("--num-keypoints", type=int, default=128)
    p.add_argument("--nms-radius", type=float, default=0.0)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="usip_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

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
