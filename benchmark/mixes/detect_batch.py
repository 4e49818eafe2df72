"""Batch-detect traffic: the export job's loop. One client keeps the card
busy with batches of clouds from a device-resident pool made from the seed
(cycled), each through the port's ``KeypointPipeline.infer``; each batch's
keypoints and sigmas are copied to the host, as the export tool's are.

``infer`` draws its nodes from the pipeline's own generator. The benchmark
keeps that generator's state before each batch; the check replays the
draws from it (a random subset of each cloud, ``argsort`` of uniforms, and
an FPS seed row), so the reference gets the same nodes' draws. After the
window the reference computes the keypoints and sigmas of a sample of the
batches, drawn from the seed, the last one always among them.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import bounds, compare, flops
from benchmark.data import kitti_scans
from benchmark.harness import Check, Outcome
from benchmark.mixes.train_engine import load_kernels
from benchmark.reference import common
from benchmark.reference import detector as ref
from benchmark.weights import port_config, seed_words, serving_detector_weights


def make_pool(ctx, z: ref.Sizes, count: int, points: int):
    """``count`` scans made from the seed, subsampled to ``input_pc_num``
    rows on the host (as a loader does), on the device: ``(pc, sn)``."""
    scans = kitti_scans.scan_pool(ctx.seed, count, points)
    rng = np.random.default_rng(seed_words(ctx.seed, 3))
    rows = np.stack([rng.choice(points, z.input_pc_num, replace=False)
                     for _ in range(count)])
    picked = np.take_along_axis(scans, rows[..., None], axis=1)
    pc = torch.from_numpy(np.ascontiguousarray(picked[..., :3]))
    sn = torch.from_numpy(np.ascontiguousarray(
        picked[..., 3:3 + z.surface_normal_len]))
    return pc.to(ctx.device), sn.to(ctx.device)


def replay_nodes(z: ref.Sizes, gen_state, b: int, n: int, device,
                 ratio: int):
    """The draws ``infer`` made for a batch from its generator's state:
    the subset rows and the FPS seed rows."""
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    sub = max(z.node_num, n // ratio)
    rows = torch.rand((b, n), generator=gen, device=device).argsort(1)
    first = torch.randint(0, sub, (b,), generator=gen, device=device)
    return rows[:, :sub], first


class Setup:
    """A detect cell after set-up: the pipeline, the pool, the weights,
    and the outputs and generator states of the window's batches."""


def setup(ctx) -> Setup:
    from usip_tpu_torch.inference import KeypointPipeline
    ctx.phase("program_imports")
    load_kernels(ctx)
    ctx.phase("kernel_load")

    s = Setup()
    t, z = ctx.traffic, ref.sizes_from(ctx.config)
    s.z, s.b = z, t["batch"]
    s.pool_pc, s.pool_sn = make_pool(ctx, z, t["pool_clouds"], t["points"])
    s.batches = t["pool_clouds"] // s.b
    ctx.phase("data")

    cfg = port_config(ctx.config)
    s.weights = serving_detector_weights(z, ctx.seed, ctx.device)
    s.pipe = KeypointPipeline(cfg, s.weights, ctx.device,
                              seed=seed_words(ctx.seed, 4) % 2 ** 62)
    s.ratio = (cfg.data.eval_fps_subsample_ratio
               or cfg.data.fps_subsample_ratio)
    ctx.phase("weights")
    s.outputs, s.states = [], []
    for i in range(t["warmup_batches"]):
        one(ctx, s, i, False)
    return s


def clouds(s: Setup, j: int):
    return (s.pool_pc[j * s.b:(j + 1) * s.b],
            s.pool_sn[j * s.b:(j + 1) * s.b])


def one(ctx, s: Setup, i: int, keep: bool) -> None:
    """Batch ``i``: infer, keypoints and sigmas to the host; kept with the
    generator's state before it where ``keep``."""
    j = i % s.batches
    pc, sn = clouds(s, j)
    state = s.pipe._gen.get_state() if keep else None
    with ctx.rec.host_span("benchmark.infer"), \
            ctx.rec.device_span("forward"):
        kp, sig = s.pipe.infer(pc, sn)
    with ctx.rec.host_span("benchmark.to_host"):
        kp, sig = kp.cpu(), sig.cpu()
    if keep:
        s.outputs.append((j, kp, sig))
        s.states.append(state)


def measure(ctx, s: Setup) -> int:
    """Batches until the window's end; the clouds detected in it."""
    from usip_tpu_torch.ops import kernels
    launches0 = dict(kernels.LAUNCHES)
    t0 = ctx.window_start()
    done, traced = 0, None
    while True:
        now = time.perf_counter()
        if now - t0 >= ctx.seconds:
            break
        if ctx.trace_due(now):
            traced = {k: kernels.LAUNCHES[k] - launches0[k]
                      for k in launches0}
            ctx.stop_trace(done * s.b)
        one(ctx, s, done, True)
        done += 1
    if ctx.tracing():
        traced = {k: kernels.LAUNCHES[k] - launches0[k] for k in launches0}
    z, b = s.z, s.b
    sub = max(z.node_num, z.input_pc_num // s.ratio)
    kb = {"fps": bounds.fps_bound(b, sub, z.node_num)[0],
          "fusion_chain": bounds.chain_bound(
              b, z.node_num, z.node_knn_k, 3 + z.c1, z.c2 // 2, z.c2)[0]}
    ctx.window_stop(done * b, flops_per_work=flops.detector_forward_flops(
        ctx.config["sizes"]),
        bounds={k: (v, (traced or {}).get(k, 0)) for k, v in kb.items()})
    return done * b


def release(ctx, s: Setup) -> None:
    s.pipe = None
    if ctx.cuda:
        torch.cuda.empty_cache()


def sample(ctx, done: int, count: int):
    """``count`` batch indices drawn from the seed, the last batch always
    among them."""
    rng = np.random.default_rng(seed_words(ctx.seed, 5))
    picks = set(rng.choice(done, min(count, done), replace=False).tolist())
    picks.add(done - 1)
    return sorted(picks)


def answers(ctx, s: Setup, precision: str = "fp32"):
    """The sampled batches' keypoints and sigmas: the program's, and the
    reference's at ``precision`` from the same clouds and node draws."""
    common.fp32_mode()
    prec = common.precision(ctx.config, precision)
    got, want = [], []
    for i in sample(ctx, len(s.outputs), ctx.traffic["checked_batches"]):
        j, kp, sig = s.outputs[i]
        pc, sn = clouds(s, j)
        rows, first = replay_nodes(s.z, s.states[i], s.b,
                                   s.z.input_pc_num, ctx.device, s.ratio)
        node = ref.sample_nodes(pc, s.z, rows, first)
        kp_r, sig_r, anchor = ref.eval_forward(s.weights, s.z, pc, sn, node,
                                               prec, anchors=True)
        got.append((kp, sig))
        want.append((kp_r.cpu(), sig_r.cpu(), anchor.cpu()))
    cat = lambda xs, i: torch.cat([x[i] for x in xs])  # noqa: E731
    return ((cat(got, 0), cat(got, 1)),
            (cat(want, 0), cat(want, 1), cat(want, 2)))


def gaps(got, want) -> dict:
    """The program's (or the control's) answers ``got`` against the fp32
    reference's ``want``, the latter's node means the unit of offset."""
    return compare.keypoint_gaps(got[0], got[1], want[0], want[1], want[2])


def run(ctx) -> Outcome:
    s = setup(ctx)
    detected = measure(ctx, s)
    ctx.read_memory()
    release(ctx, s)
    got, want = answers(ctx, s)
    wall = ctx.window.wall_s if not ctx.trace else ctx.full_window_s
    return Outcome(attempted=detected, failed=0,
                   end_to_end={"detect_clouds_per_s": detected / wall},
                   checks=[Check(k, v, ctx.limits[k])
                           for k, v in gaps(got, want).items()])


def calibration(ctx, control: bool) -> dict:
    """The program's readings and, with ``control``, the control's (the
    reference in fp8 in the program's place), of one seed's run over a
    short window at the cell's load."""
    s = setup(ctx)
    measure(ctx, s)
    release(ctx, s)
    got, want = answers(ctx, s)
    out = {"program": gaps(got, want)}
    if control:
        _, fp8 = answers(ctx, s, "fp8")
        out["control"] = gaps(fp8[:2], want)
    return out
