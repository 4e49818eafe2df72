"""Training traffic: the port's training engine over a KITTI tree written
from the seed, epoch after epoch as ``fit`` runs them (without its test
sweeps and saves), for the window's length.

Set-up writes the tree, makes the weights, builds the engine and runs its
first epoch; the first ``captured_steps`` steps of it take draws the
benchmark makes, and their batches, losses, the optimizer's first moments
after step 1 and the parameters after the last are kept. After the window
the reference follows those steps from the same weights, batches and draws,
and the worst-leaf gaps and loss gaps decide ``correct``.

The benchmark wraps the engine's ``train_step`` (CUDA events around each
call, and the window's end: a step due after it is not run) and its train
loader (the host clock around each batch it yields).
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from benchmark import compare, flops
from benchmark.data import kitti_scans
from benchmark.harness import Check, Outcome, scratch_dir
from benchmark.reference import common
from benchmark.reference import descriptor as desc_ref
from benchmark.reference import detector as ref
from benchmark.weights import (descriptor_weights, detector_weights,
                               port_config, seed_words,
                               serving_detector_weights)


class _WindowOver(Exception):
    """A step came due after the window's end."""


class TimedLoader:
    """The train loader, each batch it yields timed on the host clock."""

    def __init__(self, loader, rec):
        self.loader, self.rec = loader, rec

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        while True:
            with self.rec.host_span("benchmark.loader"):
                try:
                    batch = next(it)
                except StopIteration:
                    return
            yield batch


def make_draws(z: ref.Sizes, aug: dict, gen: torch.Generator):
    """One step's draws, from ``gen``: the reference's record."""
    b, n, m = z.batch_size, z.input_pc_num, z.node_num
    dev = gen.device
    sub = max(m, n // z.fps_subsample_ratio)

    def u(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    def nodes():
        rows = torch.rand((b, n), generator=gen, device=dev).argsort(1)
        first = torch.randint(0, sub, (b,), generator=gen, device=dev,
                              dtype=torch.int32)
        return rows[:, :sub], first

    def angles():
        if aug["rotation"] != "horizontal":
            raise ValueError(f"rotation {aug['rotation']!r} is not drawn")
        zero = torch.zeros(b, device=dev)
        return torch.stack([zero, u((b,), 0.0, 2 * math.pi), zero], -1)

    s_src, f_src = nodes()
    s_dst, f_dst = nodes()
    a_angles = angles()
    a_scale = u((b,), aug["scale_low"], aug["scale_high"])
    jitter = tuple(tuple(torch.randn(shape, generator=gen, device=dev)
                         for shape in ((b, n, 3), (b, n, z.surface_normal_len),
                                       (b, m, 3)))
                   for _ in range(2))
    g_angles = angles()
    g_scale = u((b,), 1.0 - aug["gt_scale_thre"], 1.0 + aug["gt_scale_thre"])
    g_shift = u((b, 3), -aug["gt_shift_thre"], aug["gt_shift_thre"])
    return ref.DetectorDraws(s_src, f_src, s_dst, f_dst, a_angles, a_scale,
                             jitter, g_angles, g_scale, g_shift)


def port_draws(d: ref.DetectorDraws):
    """The same draws as the port's step takes them."""
    from usip_tpu_torch.data.augment import AugmentDraws, SE3Draws
    from usip_tpu_torch.train.steps import DetectorDraws, NodeDraws
    return DetectorDraws(
        nodes_src=NodeDraws(d.subset_src, d.first_src),
        nodes_dst=NodeDraws(d.subset_dst, d.first_dst),
        shared=AugmentDraws(d.aug_angles, d.aug_scale,
                            torch.zeros_like(d.gt_shift), list(d.jitter)),
        se3=SE3Draws(d.gt_angles, d.gt_scale, d.gt_shift))


def load_kernels(ctx) -> None:
    """Build (first run of a checkout) or load the port's CUDA kernels and
    its host library."""
    from usip_tpu_torch import _build, native
    from usip_tpu_torch.ops import kernels
    if ctx.cuda:
        _build.build_all()
        for name in _build.KERNELS:
            kernels._kernel_fn(name)
    native.available()


class Setup:
    """A train cell after set-up: the engine (its first epoch run), the
    weights it started from, what was kept of the captured steps, and the
    window's counters."""


def setup(ctx) -> Setup:
    """Everything before the window: kernels, tree, weights, the engine,
    its first epoch with the captured steps."""
    ctx.phase("program_imports")
    load_kernels(ctx)
    ctx.phase("kernel_load")

    s = Setup()
    t = ctx.traffic
    s.config = ctx.config
    s.limits_names = list(ctx.limits)
    s.z = ref.sizes_from(ctx.config)
    s.role = ctx.config["role"]
    s.work = scratch_dir(ctx.cell["name"])
    tree = os.path.join(s.work, "tree")
    kitti_scans.write_tree(tree, ctx.seed, t["sequences"], t["frames_per_seq"],
                           t["points"], poses=s.role == "descriptor")
    ctx.phase("data")
    cfg = port_config(ctx.config, **{"data.dataroot": tree,
                                     "train.seed": ctx.seed})
    if s.role == "descriptor":
        return setup_descriptor(ctx, s, cfg)
    return setup_detector(ctx, s, cfg)


def setup_detector(ctx, s: Setup, cfg) -> Setup:
    from usip_tpu_torch.data.loaders import KittiDataset, ParentCloudDataset
    from usip_tpu_torch.data.pipeline import BatchLoader
    from usip_tpu_torch.train.loop import DetectorEngine
    t, z, aug = ctx.traffic, s.z, ctx.config["augment"]
    dev = ctx.device
    s.weights = detector_weights(z, ctx.seed, dev, head="init")
    s.loader = BatchLoader(
        ParentCloudDataset(KittiDataset(cfg.data, "train",
                                        sn_len=z.surface_normal_len,
                                        seed=ctx.seed)),
        z.batch_size, shuffle=True, num_workers=cfg.data.num_workers,
        seed=ctx.seed)
    s.engine = DetectorEngine(cfg, TimedLoader(s.loader, ctx.rec), None,
                              out_dir=os.path.join(s.work, "engine"),
                              device=dev)
    s.engine.state.model.load_state_dict(s.weights)
    ctx.phase("weights")

    gen = torch.Generator(device=dev).manual_seed(seed_words(ctx.seed, 2))
    captured = t["captured_steps"]
    named = list(s.engine.state.model.named_parameters())
    s.kept = kept = {"batches": [], "draws": [], "losses": []}
    s.clouds_a_step = 2 * z.batch_size
    s.count = count = {"steps": 0, "window": 0}
    s.deadline = deadline = [math.inf]
    step_fn = s.engine.train_step

    def step(state, batch, epoch, *, draws=None, generator=None, mark=None):
        now = time.perf_counter()
        if now >= deadline[0]:
            ctx.mark_end()
            raise _WindowOver
        if ctx.trace_due(now):
            ctx.stop_trace(count["window"] * s.clouds_a_step)
        i = count["steps"]
        if i < captured:
            d = make_draws(z, aug, gen)
            kept["batches"].append(tuple(x.clone() for x in batch))
            kept["draws"].append(d)
            draws = port_draws(d)
        with ctx.rec.host_span("benchmark.train_step"), \
                ctx.rec.device_span("train_step"):
            metrics = step_fn(state, batch, epoch, draws=draws,
                              generator=generator)
        if i < captured:
            kept["losses"].append(metrics["loss"].detach().clone())
            if i == 0:
                opt = state.optimizer.state
                kept["first_grads"] = {
                    n: opt[p]["exp_avg"].detach().clone() / (1 - 0.9)
                    for n, p in named}
            if i == captured - 1:
                kept["after"] = {n: p.detach().clone() for n, p in named}
        count["steps"] += 1
        if deadline[0] < math.inf:
            count["window"] += 1
        return metrics

    s.engine.train_step = step
    s.engine.train_epoch(0)       # warm-up: the whole first epoch
    return s


def make_descriptor_draws(z: ref.Sizes, gen: torch.Generator):
    """One descriptor step's draws, from ``gen``."""
    b, n, m = z.batch_size, z.input_pc_num, z.node_num
    dev = gen.device
    sub = max(m, n // z.fps_subsample_ratio)

    def nodes():
        rows = torch.rand((b, n), generator=gen, device=dev).argsort(1)
        return rows[:, :sub], torch.randint(0, sub, (b,), generator=gen,
                                            device=dev, dtype=torch.int32)

    s_anc, f_anc = nodes()
    s_pos, f_pos = nodes()
    return desc_ref.DescriptorDraws(
        s_anc, f_anc, s_pos, f_pos,
        torch.rand((b, n), generator=gen, device=dev),
        torch.rand((b, n), generator=gen, device=dev))


def port_descriptor_draws(d: desc_ref.DescriptorDraws):
    from usip_tpu_torch.train.steps import DescriptorDraws, NodeDraws
    return DescriptorDraws(nodes_anc=NodeDraws(d.subset_anc, d.first_anc),
                           nodes_pos=NodeDraws(d.subset_pos, d.first_pos),
                           ball_anc=d.ball_anc, ball_pos=d.ball_pos)


def setup_descriptor(ctx, s: Setup, cfg) -> Setup:
    """The descriptor's engine on a frozen detector whose seeded weights
    the benchmark writes as a checkpoint; the KITTI pair loader with its
    pose-distance negative miner."""
    from usip_tpu_torch.data.descriptor_loaders import KittiDescriptorDataset
    from usip_tpu_torch.data.pipeline import BatchLoader
    from usip_tpu_torch.train.checkpoint import save_checkpoint
    from usip_tpu_torch.train.descriptor_loop import DescriptorEngine
    from usip_tpu_torch.train.loop import init_detector_state
    z, dev = s.z, ctx.device
    s.d = desc_ref.desc_sizes_from(ctx.config)
    s.detector_weights = serving_detector_weights(z, ctx.seed, dev)
    frozen = init_detector_state(cfg, 0, dev)
    frozen.model.load_state_dict(s.detector_weights)
    ckpt = os.path.join(s.work, "detector.pt")
    save_checkpoint(ckpt, frozen)
    del frozen
    s.weights = descriptor_weights(s.d, ctx.seed, dev)
    ds = KittiDescriptorDataset(cfg.data, "train",
                                sn_len=s.d.surface_normal_len,
                                seed=ctx.seed)
    s.loader = BatchLoader(ds, z.batch_size, shuffle=True,
                           num_workers=cfg.data.num_workers, seed=ctx.seed)

    def mine(raw):
        return ds.mine_negative_indices(np.asarray(raw["seq"]),
                                        np.asarray(raw["pose"]))

    s.engine = DescriptorEngine(cfg, ckpt,
                                train_loader=TimedLoader(s.loader, ctx.rec),
                                mine_negatives=mine,
                                out_dir=os.path.join(s.work, "engine"),
                                device=dev)
    s.engine.state.model.load_state_dict(s.weights)
    ctx.phase("weights")

    gen = torch.Generator(device=dev).manual_seed(seed_words(ctx.seed, 2))
    captured = ctx.traffic["captured_steps"]
    named = list(s.engine.state.model.named_parameters())
    s.kept = kept = {"batches": [], "draws": [], "losses": [],
                     "keypoints": []}

    def frozen_outputs(module, inputs, outputs):
        # the frozen detector's keypoints and sigmas in a captured step
        kept["keypoints"].append((outputs[1].detach().clone(),
                                  outputs[2].detach().clone()))

    hook = s.engine.detector.register_forward_hook(frozen_outputs)
    s.clouds_a_step = 2 * z.batch_size
    s.count = count = {"steps": 0, "window": 0}
    s.deadline = deadline = [math.inf]
    step_fn = s.engine.step_fn

    def step(state, detector, batch, epoch, *, draws=None, generator=None,
             mark=None):
        now = time.perf_counter()
        if now >= deadline[0]:
            ctx.mark_end()
            raise _WindowOver
        if ctx.trace_due(now):
            ctx.stop_trace(count["window"] * s.clouds_a_step)
        i = count["steps"]
        if i == captured:
            hook.remove()
        if i < captured:
            d = make_descriptor_draws(z, gen)
            kept["batches"].append((batch.x.clone(), batch.neg_idx.clone()))
            kept["draws"].append(d)
            draws = port_descriptor_draws(d)
        with ctx.rec.host_span("benchmark.train_step"), \
                ctx.rec.device_span("train_step"):
            metrics = step_fn(state, detector, batch, epoch, draws=draws,
                              generator=generator)
        if i < captured:
            kept["losses"].append(metrics["loss"].detach().clone())
            if i == 0:
                opt = state.optimizer.state
                kept["first_grads"] = {
                    n: opt[p]["exp_avg"].detach().clone() / (1 - 0.9)
                    for n, p in named}
            if i == captured - 1:
                kept["after"] = {n: p.detach().clone() for n, p in named}
        count["steps"] += 1
        if deadline[0] < math.inf:
            count["window"] += 1
        return metrics

    s.engine.step_fn = step
    s.engine.train_epoch(0)       # warm-up: the whole first epoch
    return s


def measure(ctx, s: Setup) -> int:
    """Epochs until the window's end; the clouds of the steps done in it."""
    epoch = 1
    t0 = ctx.window_start()
    s.deadline[0] = t0 + ctx.seconds
    try:
        while True:
            s.engine.train_epoch(epoch)
            epoch += 1
    except _WindowOver:
        pass
    done = s.count["window"] * s.clouds_a_step
    per_cloud = (flops.descriptor_train_flops if s.role == "descriptor"
                 else flops.detector_train_flops)(ctx.config["sizes"])
    ctx.window_stop(done, flops_per_work=per_cloud,
                    extra={"epochs_begun": epoch})
    return done


def program_record(s: Setup) -> ref.TrainRecord:
    """The captured steps as the program took them."""
    kept = s.kept
    return ref.TrainRecord(
        [float(x) for x in kept["losses"]], kept["first_grads"],
        {k: kept["after"][k] - s.weights[k] for k in kept["after"]})


def release(ctx, s: Setup) -> None:
    """Free the program's state before the reference runs."""
    s.engine = s.loader = None
    if ctx.cuda:
        torch.cuda.empty_cache()


def reference_record(s: Setup, precision: str = "fp32",
                     keypoints=None) -> ref.TrainRecord:
    """The reference's captured steps at ``precision`` (the control:
    ``'fp8'``); a descriptor's from the frozen detector's ``keypoints``
    (the program's, where not given)."""
    common.fp32_mode()
    prec = common.precision(s.config, precision)
    if s.role == "descriptor":
        return desc_ref.train_steps(s.weights, s.d, s.kept["batches"],
                                    s.kept["draws"],
                                    keypoints or s.kept["keypoints"], prec)
    return ref.train_steps(s.weights, s.z, s.kept["batches"],
                           s.kept["draws"], prec)


def detector_stage(s: Setup, precision: str = "fp32"):
    """The frozen detector's ``(keypoints, sigmas, node means)`` of each
    captured step, computed by the reference at ``precision``."""
    common.fp32_mode()
    prec = common.precision(s.config, precision)
    return [desc_ref.detector_stage(s.detector_weights, s.z, x, d, prec)
            for (x, _), d in zip(s.kept["batches"], s.kept["draws"])]


def detector_stage_gaps(keypoints, reference) -> dict:
    """The frozen detector's stage on its own: ``keypoints`` (``(kp,
    sigma)`` of each captured step) against the reference's."""
    cat = lambda xs, i: torch.cat([x[i] for x in xs]).cpu()  # noqa: E731
    found = compare.keypoint_gaps(cat(keypoints, 0), cat(keypoints, 1),
                                  cat(reference, 0), cat(reference, 1),
                                  cat(reference, 2))
    return {"detector_" + k: v for k, v in found.items()}


def half_batch_record(s: Setup) -> ref.TrainRecord:
    """The fault "half of the batch left out, the mean taken over the
    rest", planted in the reference put in the program's place: the
    captured steps over the first half of each batch."""
    h = s.z.batch_size // 2

    def cut(x):
        if isinstance(x, tuple):
            return tuple(cut(v) for v in x)
        return x[:h]

    common.fp32_mode()
    prec = common.precision(s.config)
    if s.role == "descriptor":
        # the negatives index the half batch: the next anchor of it (the
        # pairs left out are gone); the keypoints of its anchors, then of
        # its positives
        b = s.z.batch_size
        batches = [(x[:h], (torch.arange(h, device=x.device) + 1) % h)
                   for x, _ in s.kept["batches"]]
        draws = [desc_ref.DescriptorDraws(*(cut(v) for v in d))
                 for d in s.kept["draws"]]
        keypoints = [tuple(torch.cat([t[:h], t[b:b + h]]) for t in kp)
                     for kp in s.kept["keypoints"]]
        return desc_ref.train_steps(s.weights, s.d, batches, draws,
                                    keypoints, prec)
    return ref.train_steps(s.weights, s.z,
                           [cut(b) for b in s.kept["batches"]],
                           [ref.DetectorDraws(*(cut(v) for v in d))
                            for d in s.kept["draws"]], prec)


def gaps(record: ref.TrainRecord, reference: ref.TrainRecord) -> dict:
    """The three numbers compared: the worst step's loss gap, the worst
    moving leaf's first-gradient gap and change gap."""
    keep = compare.moving_leaves(reference.first_grads)
    return {
        "loss_gap": compare.loss_gap(record.losses, reference.losses),
        "grad_gap": compare.worst_leaf_gap(record.first_grads,
                                           reference.first_grads, keep),
        "change_gap": compare.worst_leaf_gap(record.change, reference.change,
                                             keep),
    }


def checks(s: Setup, record: ref.TrainRecord) -> dict:
    """The numbers of the program's captured steps (those the cell's
    limits name are compared); each infinite
    where the frozen detector gave keypoints for other clouds than the
    batch's (a step that left part of its batch out)."""
    if s.role == "descriptor" and any(
            kp.shape[0] != 2 * x.shape[0]
            for (kp, _), (x, _) in zip(s.kept["keypoints"],
                                       s.kept["batches"])):
        return dict.fromkeys(s.limits_names, math.inf)
    found = gaps(record, reference_record(s))
    if s.role == "descriptor":
        found.update(detector_stage_gaps(s.kept["keypoints"],
                                         detector_stage(s)))
    return found


def run(ctx) -> Outcome:
    s = setup(ctx)
    done = measure(ctx, s)
    ctx.read_memory()
    record = program_record(s)
    release(ctx, s)
    found = checks(s, record)
    wall = ctx.window.wall_s if not ctx.trace else ctx.full_window_s
    return Outcome(attempted=s.count["window"], failed=0,
                   end_to_end={"train_clouds_per_s": done / wall},
                   checks=[Check(k, v, ctx.limits[k])
                           for k, v in found.items() if k in ctx.limits])


def calibration(ctx, control: bool) -> dict:
    """The program's readings and, with ``control``, the control's (the
    reference in fp8 in the program's place, its own frozen detector's
    keypoints followed by the reference) and the half-batch fault's, of
    one seed's set-up; no window."""
    s = setup(ctx)
    record = program_record(s)
    release(ctx, s)
    out = {"program": checks(s, record)}
    if control:
        keypoints = None
        if s.role == "descriptor":
            stage = detector_stage(s, "fp8")
            keypoints = [(kp, sig) for kp, sig, _ in stage]
        out["control"] = gaps(reference_record(s, "fp8", keypoints),
                              reference_record(s, "fp32", keypoints))
        if keypoints is not None:
            out["control"].update(detector_stage_gaps(keypoints,
                                                      detector_stage(s)))
        out["fault_half_batch"] = gaps(half_batch_record(s),
                                       reference_record(s))
    return out
