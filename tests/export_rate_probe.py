"""Probe: the one-rank export rates of a tree of the port, on the card.

    python3 tests/export_rate_probe.py --repo DIR --work WORK [--repeats 3]
        [--frames 64] [--scenes 2] [--device cuda]

Imports ``usip_tpu_torch`` from ``DIR`` (a checkout of the repo, so that two
commits can be timed in one session, one process each) and times, from
random weights made from a seed:

* ``run_export``: the KITTI detector's keypoint export (the KITTI preset:
  16384 points, 512 nodes, 128 keypoints, batch 8) of ``--frames`` seeded
  clouds;
* ``run_export_fragments``: the indoor fragment export (the scenenn
  descriptor preset: the lite detector, 512 keypoints, balls of 448,
  batch 4) of a synthetic 3DMatch tree, ``--scenes`` scenes of 16
  fragments.

Each export runs ``--repeats`` times after one warm-up run (kernel builds
and first-call costs). Prints one JSON line: the tree, the card's name and
power limit, and each export's clouds/s (frames over the wall time of the
whole call) run by run.
"""

import argparse
import json
import os
import subprocess
import sys
import time


class _Frames:
    """``n`` seeded KITTI-sized eval frames (gaussian clouds)."""

    def __init__(self, n, points, sn_len, seed=0):
        import numpy as np
        rng = np.random.default_rng(seed)
        self.items = [{"pc": rng.normal(0, 10, (points, 3)).astype(np.float32),
                       "sn": rng.normal(size=(points, sn_len)).astype(
                           np.float32),
                       "seq": np.int64(0), "frame": np.int64(i)}
                      for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _timed(fn, repeats, device):
    """``fn()`` (an export, returning its stats) once to warm up, then
    ``repeats`` times: its frames over each run's wall time."""
    import torch
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    fn()
    rates = []
    for _ in range(repeats):
        sync()
        t0 = time.perf_counter()
        frames = fn()["frames"]
        sync()
        rates.append(frames / (time.perf_counter() - t0))
    return rates


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", required=True)
    ap.add_argument("--work", required=True)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--scenes", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.repo))
    import torch

    import usip_tpu_torch
    from usip_tpu_torch.config import get_config
    from usip_tpu_torch.data.synthetic import build_synthetic_match3d_fragments
    from usip_tpu_torch.eval.export_runner import (run_export,
                                                   run_export_fragments)
    from usip_tpu_torch.train.checkpoint import save_checkpoint
    from usip_tpu_torch.train.descriptor_loop import init_descriptor_state
    from usip_tpu_torch.train.loop import init_detector_state

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    os.makedirs(args.work, exist_ok=True)
    out = {"package": os.path.dirname(usip_tpu_torch.__file__),
           "device": args.device}
    if args.device == "cuda":
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()

    cfg = get_config("kitti")
    ckpt = os.path.join(args.work, "kitti_det.pt")
    save_checkpoint(ckpt, init_detector_state(cfg, 0))
    frames = _Frames(args.frames, cfg.data.input_pc_num,
                     cfg.detector.surface_normal_len)
    out["export_keypoints_clouds_per_s"] = _timed(
        lambda: run_export(cfg, ckpt, os.path.join(args.work, "kp"),
                           dataset=frames, device=args.device),
        args.repeats, args.device)

    m3d = os.path.join(args.work, "match3d")
    if not os.path.isdir(m3d):
        build_synthetic_match3d_fragments(m3d, scenes=args.scenes,
                                          fragments_per_scene=16, seed=1)
    pc_root = os.path.join(m3d, "fragments")
    scenes = sorted(os.listdir(pc_root))
    icfg = get_config("scenenn", role="descriptor",
                      **{"train.batch_size": 4})
    det_ckpt = os.path.join(args.work, "indoor_det.pt")
    desc_ckpt = os.path.join(args.work, "indoor_desc.pt")
    save_checkpoint(det_ckpt, init_detector_state(icfg, 0))
    save_checkpoint(desc_ckpt, init_descriptor_state(icfg, seed=321))
    out["export_fragments_clouds_per_s"] = _timed(
        lambda: run_export_fragments(
            icfg, det_ckpt, desc_ckpt, pc_root,
            os.path.join(args.work, "feats"), scenes, desired_num=512,
            device=args.device), args.repeats, args.device)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
