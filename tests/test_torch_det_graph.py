"""The detector's train step with its device part replayed as a CUDA graph
(``make_detector_train_step`` on a CUDA batch, the engine's step on one
card), the graph cache that each replayed site keeps, and the replay's span
reader of the ``kitti-som.train`` cell.

On the CPU: the step runs eagerly (the same spans, metrics and state as its
eager route, ``_inputs``), the cache's bookkeeping, and the reader. On the
card (the ``cuda`` marker; they skip elsewhere; on a GPU host, where jax is
absent, run them without the suite's conftest: ``python -m pytest
--noconftest -m cuda tests/test_torch_det_graph.py``): the replayed step
against the eager route from the same state, batches and generator seeds, a
step handed its draws, and an engine epoch through it.
"""

import contextlib
import copy

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.harness import BREAKDOWN_TOP, Window
from usip_tpu_torch.config import get_config
from usip_tpu_torch.device import GraphCache
from usip_tpu_torch.train import loop
from usip_tpu_torch.train.loop import init_detector_state
from usip_tpu_torch.train.steps import (ParentBatch,
                                        _prepare_detector_inputs,
                                        detector_draws,
                                        make_detector_train_step)
from usip_tpu_torch.utils.logging import recording

EAGER = ["inputs", "forward", "losses", "backward", "optimizer"]
REPLAYED = ["inputs", "replay", "optimizer"]

SMALL = {"data.input_pc_num": 256, "data.parent_pc_num": 320,
         "data.node_num": 16, "detector.c1": 16, "detector.c2": 32,
         "detector.node_knn_k": 4, "train.batch_size": 2}


def _batches(cfg, device, count, seed=5):
    """``count`` parent batches of N(0, 20^2) clouds in the fp16 wire."""
    rng = np.random.default_rng(seed)
    b, p = cfg.train.batch_size, cfg.data.parent_pc_num
    return [ParentBatch(
        torch.from_numpy(rng.normal(0, 20, (b, p, 3))).half().to(device),
        torch.from_numpy(rng.normal(size=(b, p, 4))).half().to(device))
        for _ in range(count)]


def _call(cfg, step, state, batch, gen, draws, eager):
    """One step from ``gen`` (or handed ``draws``); with ``eager`` through
    the step's eager route: its inputs prepared as the step prepares them
    and handed in as ``_inputs``."""
    if eager:
        return step(state, batch, 1, _inputs=_prepare_detector_inputs(
            batch, cfg, True, draws, gen))
    return step(state, batch, 1, generator=gen, draws=draws)


def _run(cfg, start, batches, device, eager=False, record=False,
         draws=None):
    """The steps over ``batches``, step i drawing from a generator seeded
    100 + i (or handed ``draws[i]``), through ``_call``: each step's metrics
    and span names, the first and last steps' gradients, the model's state
    after, the step count and the step's ``graph_counts``."""
    state = init_detector_state(cfg, 0, device)
    state.model.load_state_dict(start)
    step = make_detector_train_step(cfg)
    metrics, names, grads = [], [], []
    for i, batch in enumerate(batches):
        gen = torch.Generator(device=device).manual_seed(100 + i)
        with recording() if record else contextlib.nullcontext() as rec:
            metrics.append(_call(cfg, step, state, batch, gen,
                                 None if draws is None else draws[i], eager))
        names.append(rec.names() if record else None)
        if i in (0, len(batches) - 1):
            grads.append({n: p.grad.detach().clone()
                          for n, p in state.model.named_parameters()})
    return (metrics, names, grads,
            {k: v.detach().clone()
             for k, v in state.model.state_dict().items()},
            state.step, dict(step.graph_counts))


def test_graph_option_is_eager_on_the_cpu():
    """On the CPU the step runs eagerly: the spans of its eager route
    (``_inputs``, which the card tests hold the replay against), and its
    metrics, gradients, parameters and BatchNorm statistics bit for bit;
    ``graph_counts`` counts its calls as eager."""
    cfg = get_config("kitti", **SMALL)
    start = init_detector_state(cfg, 3).model.state_dict()
    batches = _batches(cfg, "cpu", 2)
    eager = _run(cfg, start, batches, "cpu", eager=True, record=True)
    plain = _run(cfg, start, batches, "cpu", record=True)
    assert plain[1] == eager[1] == [["usip.step." + p for p in EAGER]] * 2
    for m0, m1 in zip(eager[0], plain[0]):
        assert m0.keys() == m1.keys()
        assert all(torch.equal(m0[k], m1[k]) for k in m0)
    for g0, g1 in zip(eager[2], plain[2]):
        assert all(torch.equal(g0[k], g1[k]) for k in g0)
    assert all(torch.equal(eager[3][k], plain[3][k]) for k in eager[3])
    assert eager[4] == plain[4] == 2
    assert eager[5] == plain[5] == {"captures": 0, "replays": 0, "eager": 2}


def test_graph_cache_captures_once_a_key():
    """The cache that ``KeypointPipeline`` and both train steps keep, with a
    stub graph factory: one capture a key, the key's graph again on a
    repeated key, and the counts of each kind of call."""
    cache, made = GraphCache(), []

    def capture(key):
        made.append(key)
        return object()

    first = cache.graph(("a", 1), lambda: capture("a"))
    assert cache.graph(("a", 1), lambda: capture("again")) is first
    second = cache.graph(("b", 1), lambda: capture("b"))
    assert cache.graph(("a", 1), lambda: capture("again")) is first
    cache.eager()
    assert made == ["a", "b"] and second is not first
    assert dict(cache) == {("a", 1): first, ("b", 1): second}
    assert cache.graph_counts == {"captures": 2, "replays": 2, "eager": 1}


def _window(gaps):
    return Window(wall_s=1.0, work=0, spans_s={}, events_ms={},
                  trace={"window_s": 2.0, "idle_gaps": gaps})


READER = "idle_in.step_replay.train"


def _read(w):
    return harness.metric_reader(READER, harness.ROOT)(w)


def test_replay_reader_is_an_entry_of_the_cell():
    m = {m["name"]: m for m in harness.spec()["per_layer"]}[READER]
    assert m["workloads"] == ["kitti-som.train", "oxford-ball.train"]
    assert (m["moves"], m["layer"], m["unit"], m["better"], m["source"]) == (
        "train_clouds_per_s", "train steps", "%", "lower", "device_trace")


def test_replay_reader_reads_the_replayed_step():
    """The replay's idle share of a window, in percent of it; None without
    a trace, without the program's spans, or where the step ran eagerly."""
    w = _window([("usip.step.replay", 0.4), ("usip.step.inputs", 0.2),
                 ("usip.step.optimizer", 0.1),
                 ("Optimizer.step#Adam.step", 0.02),
                 ("usip.engine.wait_batch", 0.06),
                 ("benchmark.train_step", 0.04)])
    assert _read(w) == pytest.approx(20.0)
    assert _read(Window(1.0, 0, {}, {})) is None
    assert _read(_window([("benchmark.train_step", 0.5)])) is None
    assert _read(_window([("usip.step.backward", 0.4),
                          ("usip.engine.wait_batch", 0.1)])) is None
    full = _window([(f"usip.step.x{i}", 0.01) for i in range(BREAKDOWN_TOP)])
    assert _read(full) is None


# ----------------------------------------------------------------- card ----

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU build")
    return torch.device("cuda")


def _card_config(preset):
    """A preset at 4 parents of 5120 points sampled to 4096, at its widths;
    the Oxford preset (height scale) with point dropout besides."""
    extra = ({"train.random_pc_dropout_lower_limit": 0.5}
             if preset == "oxford" else {})
    return get_config(preset, **{"data.input_pc_num": 4096,
                                 "data.parent_pc_num": 5120,
                                 "train.batch_size": 4, **extra})


def _largest(tensors) -> float:
    return max(float(t.detach().abs().max()) for t in tensors)


def _paired_steps(cfg, start, batches, dev, draws=None):
    """Each step of ``batches`` twice from one state: on the eager route
    (``_call``), then replayed on a second model that takes the eager side's
    parameters, BatchNorm statistics, Adam state and step count first; step
    i draws from a generator seeded 100 + i (or is handed ``draws[i]``).
    Checks each pair (``_assert_same_step``); returns the replayed steps'
    span names and the replayed step's ``graph_counts``."""
    states = []
    for _ in range(2):
        state = init_detector_state(cfg, 0, dev)
        state.model.load_state_dict(start)
        states.append(state)
    steps = [make_detector_train_step(cfg) for _ in range(2)]
    names = []
    for i, batch in enumerate(batches):
        eager, replayed = states
        replayed.model.load_state_dict(eager.model.state_dict())
        # Adam's load_state_dict keeps the tensors it is given
        replayed.optimizer.load_state_dict(
            copy.deepcopy(eager.optimizer.state_dict()))
        replayed.step = eager.step
        runs = []
        for state, step, eager in zip(states, steps, (True, False)):
            gen = torch.Generator(device=dev).manual_seed(100 + i)
            with recording() as rec:
                metrics = _call(cfg, step, state, batch, gen,
                                None if draws is None else draws[i], eager)
            runs.append((metrics, state))
        names.append(rec.names())
        _assert_same_step(cfg, *runs)
    assert states[0].step == states[1].step == len(batches)
    return names, steps[1].graph_counts


def _assert_same_step(cfg, eager, replayed):
    """One replayed step against the eager step from the same state: the
    metrics of the forward bit for bit and the gradients' norm to 1e-5;
    the gradients, and Adam's moments after the step, within 1e-4 of their
    largest; the BatchNorm statistics to 1e-4 and their counts the same;
    the parameters after Adam within 1e-4 of their largest, but for the
    elements whose gradient is under 1e-4 of the largest gradient: there
    the backward's run-to-run spread on the card (its atomics sum in
    another order) flips the sign of Adam's normalised step, eager against
    eager too."""
    (m0, s0), (m1, s1) = eager, replayed
    assert m0.keys() == m1.keys()
    for k in m0:
        if k != "grad_norm":
            assert torch.equal(m0[k], m1[k]), k
    torch.testing.assert_close(m1["grad_norm"], m0["grad_norm"], rtol=1e-5,
                               atol=0.0)
    p0, p1 = list(s0.model.parameters()), list(s1.model.parameters())
    g0 = [p.grad for p in p0]
    for kind in ("grad", "exp_avg", "exp_avg_sq"):
        a = g0 if kind == "grad" else [s0.optimizer.state[p][kind] for p in p0]
        b = ([p.grad for p in p1] if kind == "grad"
             else [s1.optimizer.state[p][kind] for p in p1])
        assert _largest([y - x for x, y in zip(a, b)]) <= 1e-4 * _largest(a), (
            kind)
    noise = 1e-4 * _largest(g0)
    gap = [torch.where(g.abs() >= noise, y - x, 0.0)
           for g, x, y in zip(g0, p0, p1)]
    assert _largest(gap) <= 1e-4 * _largest(p0)
    b0, b1 = dict(s0.model.named_buffers()), dict(s1.model.named_buffers())
    for k in b0:
        if k.endswith("num_batches_tracked"):
            assert torch.equal(b0[k], b1[k]), k
        else:
            torch.testing.assert_close(b1[k], b0[k], rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["kitti", "oxford"])
def test_replayed_step_is_the_eager_step(dev, preset):
    """4 steps, each replayed from the eager step's state: the replayed
    steps open the inputs, replay and optimizer spans, capture once and
    replay after, and compute the eager steps (``_assert_same_step``)."""
    cfg = _card_config(preset)
    start = init_detector_state(cfg, 3).model.state_dict()
    names, counts = _paired_steps(cfg, start, _batches(cfg, dev, 4), dev)
    assert names[1:] == [["usip.step." + p for p in REPLAYED]] * 3
    assert counts == {"captures": 1, "replays": 3, "eager": 0}


@pytest.mark.cuda
def test_a_step_handed_its_draws_replays(dev):
    """Steps handed their draws (as the benchmark's captured steps are)
    replay the graph and compute what the eager step handed the same
    draws does."""
    cfg = _card_config("kitti")
    start = init_detector_state(cfg, 3).model.state_dict()
    batches = _batches(cfg, dev, 4)
    gen = torch.Generator(device=dev).manual_seed(7)
    draws = [detector_draws(cfg, 4, 4, gen, True, 5120) for _ in batches]
    _, counts = _paired_steps(cfg, start, batches, dev, draws)
    assert counts == {"captures": 1, "replays": 3, "eager": 0}


class _Parents:
    def __init__(self, n, p, seed=0):
        rng = np.random.default_rng(seed)
        self.items = [{"pc": rng.normal(0, 20, (p, 3)).astype(np.float32),
                       "sn": rng.normal(size=(p, 4)).astype(np.float32)}
                      for _ in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


@pytest.mark.cuda
def test_engine_epoch_replays_its_step(dev, tmp_path):
    """Two ``DetectorEngine`` epochs on the card: one capture, every other
    step a replay, finite metrics, the step count the batches'."""
    from usip_tpu_torch.data.pipeline import BatchLoader
    cfg = _card_config("kitti").with_overrides(**{"train.log_every": 1000})
    loader = BatchLoader(_Parents(16, cfg.data.parent_pc_num), 4,
                         shuffle=True, num_workers=2, seed=0)
    eng = loop.DetectorEngine(cfg, loader, device="cuda",
                              out_dir=str(tmp_path))
    with recording() as rec:
        avg = [eng.train_epoch(e) for e in range(2)]
    assert all(np.isfinite(list(a.values())).all() for a in avg)
    steps = 2 * len(loader)
    assert eng.state.step == steps
    assert eng.train_step.graph_counts == {"captures": 1,
                                           "replays": steps - 1, "eager": 0}
    assert rec.names().count("usip.step.replay") == steps
