"""Serving traffic: clients in a closed loop, each sending one LiDAR scan a
request (a 20480 x 8 scan from a host-memory pool made from the seed,
cycled) to the port's ``KeypointPipeline.detect_and_describe``, what
``serve --descriptor-checkpoint`` calls for a request, and sending the
next when the reply is back. Each request is timed from its call to its
return.

``detect_and_describe`` draws for itself: the cloud's subsample and the
padding of the keypoint chunk from the pipeline's numpy generator, the
nodes and the ball priorities from its torch generator. The benchmark keeps
both generators' states before each request; the check replays the
subsample, the node draws and the priorities from them. After the window
the reference judges a sample of the requests drawn from the seed, the
last always among them: it computes the keypoint proposals of the same
cloud with the same nodes, and the descriptors at the program's keypoints
with the same priorities.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.data import kitti_scans
from benchmark.harness import Check, Outcome
from benchmark.mixes.train_engine import load_kernels
from benchmark.reference import common
from benchmark.reference import descriptor as desc_ref
from benchmark.reference import detector as ref
from benchmark.weights import (descriptor_weights, port_config,
                               seed_words, serving_detector_weights)


class Setup:
    """A serve cell after set-up."""


def setup(ctx) -> Setup:
    from usip_tpu_torch.inference import KeypointPipeline
    ctx.phase("program_imports")
    load_kernels(ctx)
    ctx.phase("kernel_load")
    s = Setup()
    t = ctx.traffic
    s.z, s.d = ref.sizes_from(ctx.config), desc_ref.desc_sizes_from(ctx.config)
    s.pool = kitti_scans.scan_pool(ctx.seed, t["pool_scans"], t["points"])
    ctx.phase("data")
    cfg = port_config(ctx.config)
    s.det_w = serving_detector_weights(s.z, ctx.seed, ctx.device)
    s.desc_w = descriptor_weights(s.d, ctx.seed, ctx.device)
    s.pipe = KeypointPipeline(cfg, s.det_w, ctx.device,
                              seed=seed_words(ctx.seed, 4) % 2 ** 62,
                              descriptor_checkpoint=s.desc_w)
    s.ratio = (cfg.data.eval_fps_subsample_ratio
               or cfg.data.fps_subsample_ratio)
    ctx.phase("weights")
    s.latency, s.outputs = [], []
    for i in range(t["warmup_requests"]):
        request(ctx, s, i, False)
    return s


def request(ctx, s: Setup, i: int, keep: bool) -> None:
    """Request ``i``: its scan through ``detect_and_describe``, timed;
    kept with the generators' states before it where ``keep``."""
    t = ctx.traffic
    scan = s.pool[i % len(s.pool)]
    pc, sn = scan[:, :3], scan[:, 3:3 + s.d.surface_normal_len]
    states = ((s.pipe._rng.bit_generator.state, s.pipe._gen.get_state())
              if keep else None)
    t0 = time.perf_counter()
    with ctx.rec.host_span("benchmark.request"):
        kp, desc = s.pipe.detect_and_describe(
            pc, sn, num_keypoints=t["num_keypoints"],
            nms_radius=t["nms_radius"])
    took = time.perf_counter() - t0
    if keep:
        s.latency.append(took)
        s.outputs.append((i % len(s.pool), kp, desc, states))


def measure(ctx, s: Setup) -> int:
    t0 = ctx.window_start()
    done = 0
    while True:
        now = time.perf_counter()
        if now - t0 >= ctx.seconds:
            break
        if ctx.trace_due(now):
            ctx.stop_trace(done)
        request(ctx, s, done, True)
        done += 1
    ctx.window_stop(done)
    return done


def release(ctx, s: Setup) -> None:
    s.pipe = None
    if ctx.cuda:
        torch.cuda.empty_cache()


def sample(ctx, done: int, count: int):
    rng = np.random.default_rng(seed_words(ctx.seed, 5))
    picks = set(rng.choice(done, min(count, done), replace=False).tolist())
    picks.add(done - 1)
    return sorted(picks)


def replay(ctx, s: Setup, j: int, states):
    """The request's cloud as the pipeline subsampled it, its node draws
    and its ball priorities, from the generators' states."""
    rng_state, gen_state = states
    rng = np.random.default_rng()
    rng.bit_generator.state = rng_state
    z = s.z
    scan = s.pool[j]
    rows = rng.choice(scan.shape[0], z.input_pc_num, replace=False)
    fixed = torch.from_numpy(np.ascontiguousarray(
        scan[rows, :3 + s.d.surface_normal_len])).to(ctx.device)
    pc, sn = fixed[None, :, :3], fixed[None, :, 3:]
    gen = torch.Generator(device=ctx.device)
    gen.set_state(gen_state)
    sub = max(z.node_num, z.input_pc_num // s.ratio)
    subset = torch.rand((1, z.input_pc_num), generator=gen,
                        device=ctx.device).argsort(1)[:, :sub]
    first = torch.randint(0, sub, (1,), generator=gen, device=ctx.device)
    priority = torch.rand((1, z.input_pc_num), generator=gen,
                          device=ctx.device)
    return pc, sn, subset, first, priority


def judge(kp, desc, kp_ref, sig_ref, anchor_ref, desc_ref_at_kp, k: int
          ) -> dict:
    """One request's answer against the reference: its keypoints' mean
    distance from the nearest reference proposal over the mean offset of
    the proposals from their nodes' means, the share of them whose nearest
    proposal is not among the reference's ``k`` lowest-sigma ones, and its
    descriptors' mean distance from the reference's at the same
    keypoints."""
    kp = torch.as_tensor(kp, dtype=torch.float64)
    kp_ref = kp_ref.double().cpu()
    d2 = (kp[:, None, :] - kp_ref[None, :, :]).square().sum(-1)
    dist, near = d2.min(1)
    spread = (kp_ref - anchor_ref.double().cpu()).norm(dim=-1).mean()
    top = set(torch.argsort(sig_ref.cpu())[:k].tolist())
    missed = sum(1 for i in near.tolist() if i not in top) / len(near)
    gap = (torch.as_tensor(desc, dtype=torch.float64)
           - desc_ref_at_kp.double().cpu()).norm(dim=-1).mean()
    return {"keypoint_gap": float(dist.sqrt().mean() / spread),
            "selection_gap": float(missed),
            "descriptor_gap": float(gap)}


def readings(ctx, s: Setup, precision: str = "fp32") -> dict:
    """The worst sampled request's numbers: the program's answers, or with
    ``precision='fp8'`` the control's (the reference at float8 in the
    program's place), judged by the fp32 reference."""
    common.fp32_mode()
    exact = common.precision(ctx.config)
    k = ctx.traffic["num_keypoints"]
    worst: dict = {}
    for i in sample(ctx, len(s.outputs), ctx.traffic["checked_requests"]):
        j, kp, desc, states = s.outputs[i]
        pc, sn, subset, first, priority = replay(ctx, s, j, states)
        node = ref.sample_nodes(pc, s.z, subset, first)
        kp_r, sig_r, anchor = ref.eval_forward(s.det_w, s.z, pc, sn, node,
                                               exact, anchors=True)
        if precision != "fp32":
            prec = common.precision(ctx.config, precision)
            kp_c, sig_c = ref.eval_forward(s.det_w, s.z, pc, sn, node, prec)
            kp = kp_c[0][torch.argsort(sig_c[0])[:k]]
            desc = desc_ref.eval_describe(s.desc_w, s.d, pc, sn, kp[None],
                                          priority, prec)[0].cpu()
            kp = kp.cpu()
        kp_t = torch.as_tensor(np.asarray(kp), dtype=torch.float32,
                               device=ctx.device)[None]
        d_r = desc_ref.eval_describe(s.desc_w, s.d, pc, sn, kp_t, priority,
                                     exact)
        found = judge(kp, desc, kp_r[0], sig_r[0], anchor[0], d_r[0], k)
        for name, v in found.items():
            worst[name] = max(worst.get(name, 0.0), v)
    return worst


def run(ctx) -> Outcome:
    s = setup(ctx)
    done = measure(ctx, s)
    ctx.read_memory()
    release(ctx, s)
    found = readings(ctx, s)
    lat = np.asarray(s.latency) * 1e3
    return Outcome(attempted=done, failed=0,
                   end_to_end={"request_p95_ms": float(np.percentile(lat, 95))},
                   checks=[Check(k, v, ctx.limits[k])
                           for k, v in found.items()])


def calibration(ctx, control: bool) -> dict:
    s = setup(ctx)
    measure(ctx, s)
    release(ctx, s)
    out = {"program": readings(ctx, s)}
    if control:
        out["control"] = readings(ctx, s, "fp8")
    return out
