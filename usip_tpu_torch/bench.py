"""Detect throughput of the port on the card (counterpart of the repo's
``bench.py``):

    python -m usip_tpu_torch.bench [--device cuda]
    python -m usip_tpu_torch.cli bench [--device cuda]

Prints one JSON line. The protocol is bench.py's: the KITTI preset (N=16384,
M=512, c1=128, c2=512, K=16, sn 4, bf16 trunk), batch 8, FPS node sampling
plus the eval forward (``KeypointPipeline.infer``: FPS, min/argmin,
scatter-max, smallest-k and the fused chain on the card), two warm-up calls,
then the best of 3 passes of 50 pipelined iterations with one synchronize a
pass. Weights are the detector's initialisers from a seed, as bench.py's.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from usip_tpu_torch.config import get_config
from usip_tpu_torch.inference import KeypointPipeline, resolve_device

METRIC = "kitti_16k_detection_clouds_per_sec_per_chip"
# bench.py's yardstick: USIP-era PyTorch on a GTX 1080 Ti-class GPU at this
# configuration, the export tool's batch-of-8 timing (an assumption bench.py
# records; the reference publishes no numbers)
REFERENCE_CLOUDS_PER_SEC = 30.0
# bench.py's protocol: batch 8, passes of 50 pipelined iterations
BATCH, ITERS = 8, 50


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_rate(pipe: KeypointPipeline, pc: torch.Tensor, sn: torch.Tensor,
               iters: int = ITERS, passes: int = 3):
    """bench.py's protocol on ``pipe.infer``: two warm-up calls, then the
    best of ``passes`` x ``iters`` pipelined calls, one synchronize a pass
    -> (clouds/s, ms a batch, peak device MiB or None off the card)."""
    dev = pc.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(2):
        pipe.infer(pc, sn)
    _sync(dev)
    best = float("inf")
    for _ in range(passes):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = pipe.infer(pc, sn)
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    if not bool(torch.isfinite(out[0]).all()):
        raise FloatingPointError("bench: non-finite keypoints")
    peak = (torch.cuda.max_memory_allocated(dev) / 2**20
            if dev.type == "cuda" else None)
    return pc.shape[0] * iters / best, best / iters * 1e3, peak


def bench_inputs(cfg, batch: int, seed: int = 0):
    """bench.py's inputs: N(0, 20^2) coordinates, unit normals and a
    feature column."""
    rng = np.random.default_rng(seed)
    n, s = cfg.data.input_pc_num, cfg.detector.surface_normal_len
    pc = (rng.normal(size=(batch, n, 3)) * 20).astype(np.float32)
    sn = rng.normal(size=(batch, n, s)).astype(np.float32)
    sn[..., :3] /= np.linalg.norm(sn[..., :3], axis=-1, keepdims=True)
    return pc, sn


def main(argv=None):
    ap = argparse.ArgumentParser(prog="usip_tpu_torch.bench")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' fails when CUDA is absent")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    from usip_tpu_torch.train.loop import init_detector_state
    cfg = get_config("kitti")
    sd = init_detector_state(cfg, seed=0).model.state_dict()
    pipe = KeypointPipeline(cfg, sd, dev)
    pc, sn = (torch.from_numpy(a).to(dev)
              for a in bench_inputs(cfg, BATCH))
    rate, ms, peak = bench_rate(pipe, pc, sn, ITERS)
    print(json.dumps({
        "metric": METRIC, "value": round(rate, 2), "unit": "clouds/sec/chip",
        "vs_baseline": round(rate / REFERENCE_CLOUDS_PER_SEC, 2),
        "ms_per_batch": ms, "batch": BATCH, "iters": ITERS,
        "peak_mib": peak, "device": (torch.cuda.get_device_name(dev)
                                     if dev.type == "cuda" else "cpu")}),
          flush=True)


if __name__ == "__main__":
    main()
