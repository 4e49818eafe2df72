"""Oxford training traffic: the port's training engine with the ball
detector (``detector.grouping=ball``) over an Oxford RobotCar tree written
from the seed, epoch after epoch as ``fit`` runs them (without its test
sweeps and saves), for the window's length.

The same run as ``train_engine``'s detector cells, whose helpers it takes:
set-up writes the tree, makes the weights, builds the engine over the
native loader's parent batches (``OxfordDataset``, its ENU-to-camera flip)
and runs the first epoch; the first ``captured_steps`` steps take draws the
benchmark makes (the height scale among them) and are kept. After the
window the reference (``benchmark/reference/ball_detector.py``) follows
those steps from the same weights, batches and draws, and the worst-leaf
gaps and loss gaps decide ``correct``. The run also prints the fill of the
captured steps' balls, and hands the readers the ball query's K4 bound
with its launches in the traced part (one a step).
"""

from __future__ import annotations

import json
import math
import os
import time

import torch

from benchmark import bounds
from benchmark.data import oxford_scans
from benchmark.harness import Check, Outcome, scratch_dir
from benchmark.mixes import train_engine as base
from benchmark.reference import ball_detector as bd
from benchmark.reference import common
from benchmark.weights import make_tensors, port_config, seed_words

# the configuration file's keys that ``weights.PORT_KEYS`` leaves out ->
# the port's dotted config key
GROUP_KEYS = {"grouping": "detector.grouping",
              "group_radius": "detector.group_radius",
              "group_k": "detector.group_k"}
AUGMENT_KEYS = {"scale_low": "augment.aug_scale_low",
                "scale_high": "augment.aug_scale_high",
                "height_scale_low": "augment.height_scale_low",
                "height_scale_high": "augment.height_scale_high",
                "gt_scale_thre": "augment.gt_scale_thre",
                "gt_shift_thre": "augment.gt_shift_thre"}


def port_overrides(config: dict) -> dict:
    """The dotted keys that set the ball trunk and Oxford's augmentation
    from the configuration file."""
    aug = config["augment"]
    if aug["rotation"] != "horizontal":
        raise ValueError(f"rotation {aug['rotation']!r} is not drawn")
    out = {v: config["sizes"][k] for k, v in GROUP_KEYS.items()}
    out.update({v: aug[k] for k, v in AUGMENT_KEYS.items()})
    out.update({"augment.rot_horizontal": True, "augment.height_scale": True})
    return out


def make_draws(z: bd.BallSizes, aug: dict, gen: torch.Generator
               ) -> bd.BallDraws:
    """One step's draws, from ``gen``: the SOM cell's, then the height
    scales."""
    d = base.make_draws(z, aug, gen)
    u = torch.rand((z.batch_size,), generator=gen, device=gen.device)
    lo, hi = aug["height_scale_low"], aug["height_scale_high"]
    return bd.BallDraws(*d, lo + (hi - lo) * u)


def port_draws(d: bd.BallDraws):
    return base.port_draws(d)._replace(height=d.height)


def ball_select_ms(z: bd.BallSizes) -> float:
    """K4's bound for one step's ball query: the (2B, M, N) scores read,
    the (2B, M, K) values and indices written."""
    b, m, n, k = 2 * z.batch_size, z.node_num, z.input_pc_num, z.group_k
    return bounds.bound(b * m * n * 4 + b * m * k * 8, 0,
                        bounds.FP32_FLOPS)[0]


def setup(ctx) -> base.Setup:
    """Everything before the window: kernels, tree, weights, the engine,
    its first epoch with the captured steps."""
    from usip_tpu_torch.data.loaders import OxfordDataset, ParentCloudDataset
    from usip_tpu_torch.data.pipeline import BatchLoader
    from usip_tpu_torch.train.loop import DetectorEngine
    ctx.phase("program_imports")
    base.load_kernels(ctx)
    ctx.phase("kernel_load")

    s = base.Setup()
    t, dev = ctx.traffic, ctx.device
    s.config = ctx.config
    s.z = z = bd.sizes_from(ctx.config)
    s.work = scratch_dir(ctx.cell["name"])
    tree = os.path.join(s.work, "tree")
    oxford_scans.write_tree(tree, ctx.seed, t["traversals"], t["submaps"],
                            t["points"], t["scan_radius"], t["spacing"])
    ctx.phase("data")
    cfg = port_config(ctx.config, **port_overrides(ctx.config),
                      **{"data.dataroot": tree, "train.seed": ctx.seed})
    s.weights = make_tensors(bd.param_shapes(z), ctx.seed, 1, dev, "init")
    s.loader = BatchLoader(
        ParentCloudDataset(OxfordDataset(cfg.data, "train",
                                         sn_len=z.surface_normal_len,
                                         seed=ctx.seed)),
        z.batch_size, shuffle=True, num_workers=cfg.data.num_workers,
        seed=ctx.seed)
    s.engine = DetectorEngine(cfg, base.TimedLoader(s.loader, ctx.rec), None,
                              out_dir=os.path.join(s.work, "engine"),
                              device=dev)
    s.engine.state.model.load_state_dict(s.weights)
    ctx.phase("weights")

    gen = torch.Generator(device=dev).manual_seed(seed_words(ctx.seed, 2))
    captured = t["captured_steps"]
    named = list(s.engine.state.model.named_parameters())
    s.kept = kept = {"batches": [], "draws": [], "losses": []}
    s.clouds_a_step = 2 * z.batch_size
    s.count = count = {"steps": 0, "window": 0, "traced": None}
    s.deadline = deadline = [math.inf]
    step_fn = s.engine.train_step

    def step(state, batch, epoch, *, draws=None, generator=None, mark=None):
        now = time.perf_counter()
        if now >= deadline[0]:
            ctx.mark_end()
            raise base._WindowOver
        if ctx.trace_due(now):
            count["traced"] = count["window"]
            ctx.stop_trace(count["window"] * s.clouds_a_step)
        i = count["steps"]
        if i < captured:
            d = make_draws(z, ctx.config["augment"], gen)
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


def measure(ctx, s: base.Setup) -> int:
    """Epochs until the window's end; the clouds of the steps done in it."""
    epoch = 1
    t0 = ctx.window_start()
    s.deadline[0] = t0 + ctx.seconds
    try:
        while True:
            s.engine.train_epoch(epoch)
            epoch += 1
    except base._WindowOver:
        pass
    done = s.count["window"] * s.clouds_a_step
    traced = s.count["traced"]
    if traced is None:
        traced = s.count["window"]
    ctx.window_stop(done, flops_per_work=bd.train_flops(ctx.config["sizes"]),
                    bounds={"ball_select": (ball_select_ms(s.z), traced)},
                    extra={"epochs_begun": epoch})
    return done


def reference_record(s: base.Setup, precision: str = "fp32"
                     ) -> bd.det.TrainRecord:
    """The reference's captured steps at ``precision`` (the control:
    ``'fp8'``)."""
    common.fp32_mode()
    return bd.train_steps(s.weights, s.z, s.kept["batches"], s.kept["draws"],
                          common.precision(s.config, precision))


def half_batch_record(s: base.Setup) -> bd.det.TrainRecord:
    """The fault "half of the batch left out": the reference's captured
    steps over the first half of each batch, in the program's place."""
    h = s.z.batch_size // 2

    def cut(x):
        if isinstance(x, tuple):
            return type(x)(*map(cut, x)) if hasattr(x, "_fields") else tuple(
                map(cut, x))
        return x[:h]

    common.fp32_mode()
    return bd.train_steps(s.weights, s.z, [cut(b) for b in s.kept["batches"]],
                          [cut(d) for d in s.kept["draws"]],
                          common.precision(s.config))


def ball_fill(s: base.Setup) -> dict:
    """The captured steps' balls: the share that hold ``group_k`` points,
    the share that are empty, and the mean count (capped at ``group_k``)."""
    counts = torch.cat([bd.step_fill(s.z, pc, sn, d) for (pc, sn), d
                        in zip(s.kept["batches"], s.kept["draws"])])
    k = s.z.group_k
    return {"full_share": float((counts >= k).float().mean()),
            "empty_share": float((counts == 0).float().mean()),
            "mean_count": float(counts.clamp(max=k).float().mean()),
            "balls": int(counts.numel())}


def run(ctx) -> Outcome:
    s = setup(ctx)
    done = measure(ctx, s)
    ctx.read_memory()
    record = base.program_record(s)
    base.release(ctx, s)
    found = base.gaps(record, reference_record(s))
    print("ball_fill " + json.dumps(ball_fill(s)), flush=True)
    wall = ctx.window.wall_s if not ctx.trace else ctx.full_window_s
    return Outcome(attempted=s.count["window"], failed=0,
                   end_to_end={"train_clouds_per_s": done / wall},
                   checks=[Check(k, v, ctx.limits[k])
                           for k, v in found.items() if k in ctx.limits])


def calibration(ctx, control: bool) -> dict:
    """The program's readings and, with ``control``, the control's (the
    reference in fp8 in the program's place) and the half-batch fault's,
    of one seed's set-up; no window."""
    s = setup(ctx)
    record = base.program_record(s)
    base.release(ctx, s)
    ref = reference_record(s)
    out = {"program": base.gaps(record, ref), "ball_fill": ball_fill(s)}
    if control:
        out["control"] = base.gaps(reference_record(s, "fp8"), ref)
        out["fault_half_batch"] = base.gaps(half_batch_record(s), ref)
    return out
