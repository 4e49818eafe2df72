"""The descriptor's train step with its device part replayed as a CUDA graph
(``make_descriptor_train_step`` on a packed CUDA batch drawn from a CUDA
generator, the engine's step on one card), and the span readers of the
``kitti-desc.train`` cell.

On the CPU: the step runs eagerly (the same spans, metrics and state as its
eager route, handed the draws ``descriptor_draws`` makes from the same
generator), and the readers. On the card (the ``cuda`` marker; they skip
elsewhere; on a GPU host, where jax is absent, run them without the suite's
conftest: ``python -m pytest --noconftest -m cuda
tests/test_torch_desc_graph.py``): the replayed step against the eager route
from the same state, batches and generator seeds, and an engine epoch
through it.
"""

import contextlib

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.harness import BREAKDOWN_TOP, Window
from usip_tpu_torch.config import get_config
from usip_tpu_torch.models import Descriptor
from usip_tpu_torch.models.detector import Detector
from usip_tpu_torch.ops import kernels
from usip_tpu_torch.train import descriptor_loop
from usip_tpu_torch.train.state import TrainState
from usip_tpu_torch.train.steps import (PackedPairBatch, descriptor_draws,
                                        make_descriptor_train_step,
                                        pack_pair_batch)
from usip_tpu_torch.utils.logging import recording
from usip_tpu_torch.weights import (seeded_descriptor_state_dict,
                                    seeded_state_dict)

EAGER = ["inputs", "detector", "group", "describe", "losses", "backward",
         "optimizer"]

SMALL = {"data.input_pc_num": 256, "data.node_num": 16, "detector.c1": 16,
         "detector.c2": 32, "detector.node_knn_k": 4,
         "descriptor.descriptor_len": 16, "descriptor.ball_nsamples": 8,
         "descriptor.ball_radius": 0.75, "train.batch_size": 2}


def _models(cfg, device):
    """The frozen detector (its head at the training init's scale, so the
    sigmas stay under the loss's sigma_max) and the descriptor's start."""
    sd = {k: torch.tensor(v)
          for k, v in seeded_state_dict(cfg.detector, 3).items()}
    sd["mlp3.conv.weight"] *= 1e-4 / 0.05
    sd["mlp3.conv.bias"].zero_()
    det = Detector(cfg.detector)
    det.load_state_dict(sd, strict=True)
    start = {k: torch.tensor(v) for k, v in seeded_descriptor_state_dict(
        cfg.descriptor, 4).items()}
    return det.to(device).eval().requires_grad_(False), start


def _batches(cfg, device, count, seed=5):
    """``count`` packed pair batches: clouds of N(0, 3^2) points, the
    positive a reordered copy moved by N(0, 0.05^2)."""
    rng = np.random.default_rng(seed)
    b, n = cfg.train.batch_size, cfg.data.input_pc_num
    out = []
    for _ in range(count):
        pc = rng.normal(0, 3, (b, n, 3)).astype(np.float32)
        sn = rng.normal(size=(b, n, 4)).astype(np.float32)
        perm = np.stack([rng.permutation(n) for _ in range(b)])
        pos = np.take_along_axis(pc, perm[..., None], 1) + rng.normal(
            0, 0.05, pc.shape).astype(np.float32)
        pos_sn = np.take_along_axis(sn, perm[..., None], 1)
        packed = pack_pair_batch(pc, sn, pos, pos_sn, (np.arange(b) + 1) % b)
        out.append(PackedPairBatch(torch.from_numpy(packed.x).to(device),
                                   torch.from_numpy(packed.neg_idx).long()
                                   .to(device)))
    return out


def _run(cfg, det, start, batches, device, eager=False, record=False):
    """The steps over ``batches``, step i drawing from a generator seeded
    100 + i; with ``eager`` through the step's eager route, handed the
    draws ``descriptor_draws`` makes from that generator: each step's
    metrics and span names, the first step's gradients, the descriptor's
    state and Adam moments after, the step count and the step's
    ``graph_counts``."""
    desc = Descriptor(cfg.descriptor)
    desc.load_state_dict(start)
    state = TrainState.create(desc.to(device), cfg.train.lr)
    step = make_descriptor_train_step(cfg)
    metrics, names, grads = [], [], None
    for i, batch in enumerate(batches):
        gen = torch.Generator(device=device).manual_seed(100 + i)
        b, _, n, _ = batch.x.shape
        with recording() if record else contextlib.nullcontext() as rec:
            if eager:
                metrics.append(step(state, det, batch, 1, draws=(
                    descriptor_draws(cfg, b, n, gen))))
            else:
                metrics.append(step(state, det, batch, 1, generator=gen))
        names.append(rec.names() if record else None)
        if i == 0:
            grads = {n: p.grad.detach().clone()
                     for n, p in desc.named_parameters()}
    moments = {n: state.optimizer.state[p]["exp_avg"].detach().clone()
               for n, p in desc.named_parameters()}
    return (metrics, names, grads,
            {k: v.detach().clone() for k, v in desc.state_dict().items()},
            moments, state.step, dict(step.graph_counts))


def test_graph_option_is_eager_on_the_cpu():
    """On the CPU the step runs eagerly: the spans of its eager route
    (handed draws, which the card tests hold the replay against), and its
    metrics, state and moments bit for bit; ``graph_counts`` counts its
    calls as eager."""
    cfg = get_config("kitti", role="descriptor", **SMALL)
    det, start = _models(cfg, "cpu")
    batches = _batches(cfg, "cpu", 2)
    eager = _run(cfg, det, start, batches, "cpu", eager=True, record=True)
    plain = _run(cfg, det, start, batches, "cpu", record=True)
    assert plain[1] == eager[1] == [["usip.step." + p for p in EAGER]] * 2
    for m0, m1 in zip(eager[0], plain[0]):
        assert m0.keys() == m1.keys()
        assert all(torch.equal(m0[k], m1[k]) for k in m0)
    for a, b in ((eager[3], plain[3]), (eager[4], plain[4])):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert eager[5] == plain[5] == 2
    assert eager[6] == plain[6] == {"captures": 0, "replays": 0, "eager": 2}


def _window(gaps):
    return Window(wall_s=1.0, work=0, spans_s={}, events_ms={},
                  trace={"window_s": 2.0, "idle_gaps": gaps})


def _read(name, w):
    return harness.metric_reader(name, harness.ROOT)(w)


READERS = ("idle_in.step_replay.desc_train", "idle_in.wait_batch.desc_train")


@pytest.mark.parametrize("name", READERS)
def test_desc_train_readers_are_entries_of_the_cell(name):
    m = {m["name"]: m for m in harness.spec()["per_layer"]}[name]
    assert m["workloads"] == ["kitti-desc.train"]
    assert (m["moves"], m["unit"], m["better"], m["source"]) == (
        "train_clouds_per_s", "%", "lower", "device_trace")


def test_desc_train_readers_split_the_replayed_step():
    """Each reader's share of a window, in percent of it; none without the
    program's spans; the replay's none where the step ran eagerly."""
    w = _window([("usip.step.replay", 0.4), ("usip.step.inputs", 0.2),
                 ("usip.step.optimizer", 0.1),
                 ("Optimizer.step#Adam.step", 0.02),
                 ("usip.engine.wait_batch", 0.06),
                 ("benchmark.train_step", 0.04)])
    got = {n: _read(n, w) for n in READERS}
    assert got == pytest.approx({READERS[0]: 20.0, READERS[1]: 3.0})
    for name in READERS:
        assert _read(name, Window(1.0, 0, {}, {})) is None
        assert _read(name, _window([("benchmark.train_step", 0.5)])) is None
    eager = _window([("usip.step.backward", 0.4),
                     ("usip.engine.wait_batch", 0.1)])
    assert _read(READERS[0], eager) is None
    assert _read(READERS[1], eager) == pytest.approx(5.0)
    full = _window([(f"usip.step.x{i}", 0.01) for i in range(BREAKDOWN_TOP)])
    assert all(_read(n, full) is None for n in READERS)


# ----------------------------------------------------------------- card ----

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU build")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 16384])
def test_replayed_step_is_the_eager_step(dev, n):
    """The KITTI descriptor preset (bf16 balls and trunk, 256 keypoints,
    balls of 64 in 2 m) at 4 pairs of ``n`` points, 4 steps from one start
    on the eager route and replayed: the replayed steps open the inputs,
    replay and optimizer spans and capture once; a replay counts the eager step's launches; the first
    step's loss and metrics are the same to fp32 rounding and its
    gradients within 1e-4 of their largest (the backward's atomics sum in
    another order); every step's loss within 1e-3; the BatchNorm
    statistics within 1e-4 after the 4 steps and their counts and the step
    count the same (the capture's warm-ups leave no trace)."""
    cfg = get_config("kitti", role="descriptor",
                     **{"data.input_pc_num": n, "train.batch_size": 4})
    det, start = _models(cfg, dev)
    batches = _batches(cfg, dev, 4)
    launches = []
    runs = []
    for eager in (True, False):
        kernels.reset_launch_counts()
        runs.append(_run(cfg, det, start, batches, dev, eager, record=True))
        torch.cuda.synchronize()
        launches.append(dict(kernels.LAUNCHES))
    ((m0, names0, g0, s0, _, steps0, counts0),
     (m1, names1, g1, s1, _, steps1, counts1)) = runs
    assert names0 == [["usip.step." + p for p in EAGER]] * 4
    assert names1[1:] == [["usip.step." + p for p in
                           ("inputs", "replay", "optimizer")]] * 3
    assert counts0 == {"captures": 0, "replays": 0, "eager": 4}
    assert counts1 == {"captures": 1, "replays": 3, "eager": 0}
    # the capture's three warm-up runs count as the eager steps they are
    assert {k: 4 * v for k, v in launches[1].items()} == {
        k: 7 * v for k, v in launches[0].items()}
    assert m0[0].keys() == m1[0].keys()
    for k in m0[0]:
        torch.testing.assert_close(m1[0][k], m0[0][k], rtol=1e-5, atol=1e-6)
    for k in g0:
        scale = float(g0[k].abs().max()) + 1e-12
        assert float((g1[k] - g0[k]).abs().max()) <= 1e-4 * scale, k
    for a, b in zip(m0, m1):
        torch.testing.assert_close(b["loss"], a["loss"], rtol=1e-3,
                                   atol=1e-6)
    for k in s0:
        if k.endswith("num_batches_tracked"):
            assert torch.equal(s0[k], s1[k]), k
        elif "running" in k:
            torch.testing.assert_close(s1[k], s0[k], rtol=1e-4, atol=1e-5)
    assert steps0 == steps1 == 4


@pytest.mark.cuda
def test_a_step_handed_its_draws_runs_eagerly(dev):
    """On the card a step handed its draws (the benchmark's captured steps)
    opens the eager spans, and the replayed steps after it go on."""
    cfg = get_config("kitti", role="descriptor",
                     **{"data.input_pc_num": 4096, "train.batch_size": 4})
    det, start = _models(cfg, dev)
    batches = _batches(cfg, dev, 3)
    desc = Descriptor(cfg.descriptor)
    desc.load_state_dict(start)
    state = TrainState.create(desc.to(dev), cfg.train.lr)
    step = make_descriptor_train_step(cfg)
    gen = torch.Generator(device=dev).manual_seed(7)
    with recording() as rec:
        step(state, det, batches[0], 0,
             draws=descriptor_draws(cfg, 4, 4096, gen))
    assert rec.names() == ["usip.step." + p for p in EAGER]
    for batch in batches[1:]:
        with recording() as rec:
            m = step(state, det, batch, 0, generator=gen)
        assert "usip.step.replay" in rec.names()
        assert all(bool(torch.isfinite(v)) for v in m.values())
    assert state.step == 3
    assert step.graph_counts == {"captures": 1, "replays": 1, "eager": 1}


@pytest.mark.cuda
def test_engine_epochs_replay_their_step(dev, tmp_path):
    """Two ``DescriptorEngine`` epochs on synthetic pairs on the card: every
    step replays its graph, the metrics are finite and the step count is
    the batches'."""
    from usip_tpu_torch.train.checkpoint import save_checkpoint
    from usip_tpu_torch.train.loop import init_detector_state
    cfg = get_config("kitti", role="descriptor",
                     **{"data.input_pc_num": 4096, "data.parent_pc_num": 5120,
                        "train.batch_size": 4, "train.log_every": 1000})
    ckpt = str(tmp_path / "det.pt")
    save_checkpoint(ckpt, init_detector_state(cfg, 0))
    eng = descriptor_loop.DescriptorEngine(cfg, ckpt, synthetic=True,
                                           device="cuda",
                                           out_dir=str(tmp_path / "e"))
    with recording() as rec:
        avg = [eng.train_epoch(e) for e in range(2)]
    assert all(np.isfinite(list(a.values())).all() for a in avg)
    steps = 2 * len(eng.train_loader)
    assert eng.state.step == steps
    assert rec.names().count("usip.step.replay") == steps
    counts = eng.step_fn.graph_counts
    assert counts["eager"] == 0
    assert counts["captures"] + counts["replays"] == steps
