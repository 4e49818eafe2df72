"""``KeypointPipeline.infer`` around its CUDA graphs, on the CPU: the CPU
runs eagerly the forward a graph captures, with the draws of
``sample_nodes``; ``node_draws`` is the recipe the benchmark replays; the
launch counts a capture takes off and a replay gives back; the reader of
the idle share in the replay's span. The graphs themselves run on the card
(``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from benchmark import harness
from usip_tpu_torch.config import get_config
from usip_tpu_torch.inference import KeypointPipeline
from usip_tpu_torch.models.fused_infer import detector_infer_fused
from usip_tpu_torch.ops import kernels
from usip_tpu_torch.ops.sampling import node_draws, sample_nodes
from usip_tpu_torch.utils.logging import recording
from usip_tpu_torch.weights import seeded_state_dict

torch.set_num_threads(1)

TINY = {"data.input_pc_num": 128, "data.node_num": 16, "detector.c1": 16,
        "detector.c2": 32, "detector.node_knn_k": 4}


def _pipeline(seed=3, **over):
    cfg = get_config("kitti", **{**TINY, **over})
    sd = {k: torch.tensor(v) for k, v in
          seeded_state_dict(cfg.detector, 0).items()}
    return cfg, KeypointPipeline(cfg, sd, "cpu", seed=seed)


def _clouds(cfg, b, seed):
    rng = np.random.default_rng(seed)
    n, s = cfg.data.input_pc_num, cfg.detector.surface_normal_len
    return (torch.from_numpy(rng.normal(size=(b, n, 3)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(b, n, s)).astype(np.float32)))


def _ratio(cfg):
    return cfg.data.eval_fps_subsample_ratio or cfg.data.fps_subsample_ratio


@pytest.mark.parametrize("b", [1, 3])
def test_infer_on_the_cpu_is_eager(b):
    """The CPU takes the eager path on every call: ``graph_counts`` counts
    eager calls, nothing is captured, and the spans are the eager
    forward's."""
    cfg, pipe = _pipeline()
    for i in range(3):
        pipe.infer(*_clouds(cfg, b, i))
    with recording() as rec:
        pipe.infer(*_clouds(cfg, b, 9))
    assert pipe.graph_counts == {"captures": 0, "replays": 0, "eager": 4}
    assert pipe._graphs == {} and pipe._pool is None
    assert rec.names() == ["usip.infer." + p for p in (
        "nodes", "trunk", "fusion", "head")]


@pytest.mark.parametrize("fps_parallel", [1, 4])
def test_infer_on_the_cpu_equals_its_draws_then_the_forward(fps_parallel):
    """Over consecutive calls, ``infer`` equals ``sample_nodes`` drawing
    from a generator of the same seed followed by
    ``detector_infer_fused``, bit for bit, and leaves its generator where
    that one ends: the draws' calls and order are unchanged."""
    cfg, pipe = _pipeline(seed=11, **{"data.fps_parallel": fps_parallel})
    gen = torch.Generator().manual_seed(11)
    for i in range(3):
        pc, sn = _clouds(cfg, 2, i)
        kp, sig = pipe.infer(pc, sn)
        node = sample_nodes(pc, cfg.data.node_num, _ratio(cfg),
                            cfg.data.fps_parallel, generator=gen)
        _, kp_ref, sig_ref = detector_infer_fused(pipe.detector, pc, sn,
                                                  node)
        assert torch.equal(kp, kp_ref) and torch.equal(sig, sig_ref)
        assert torch.equal(pipe._gen.get_state(), gen.get_state())


@pytest.mark.parametrize("b,n,node_num,ratio,parallel", [
    (2, 128, 16, 8, 1), (2, 128, 16, 8, 4), (3, 1000, 64, 4, 4),
    (1, 100, 64, 8, 3)])
def test_node_draws_are_torch_rand_argsort_and_randint(b, n, node_num, ratio,
                                                       parallel):
    """``node_draws`` (the uniforms ``draw_node_uniforms`` writes in place,
    then ``draws_from_uniforms``) equals the recipe the benchmark replays:
    ``torch.rand`` argsorted for the subset rows, then ``torch.randint``
    for the FPS seed rows, from a generator of the same seed, and leaves
    the generator where that recipe does."""
    gen, ref = torch.Generator().manual_seed(b * n), torch.Generator()
    ref.manual_seed(b * n)
    for _ in range(2):
        subset, first = node_draws(b, n, node_num, ratio, parallel,
                                   generator=gen)
        sub = max(node_num, n // ratio)
        bins = parallel if not (sub % parallel or node_num % parallel) else 1
        rows = torch.rand((b, n), generator=ref).argsort(1)[:, :sub]
        seeds = torch.randint(0, sub // bins, (b * bins,), generator=ref)
        assert torch.equal(subset, rows)
        assert first.dtype == torch.int32 and torch.equal(first.long(), seeds)
        assert torch.equal(gen.get_state(), ref.get_state())


@pytest.mark.parametrize("made", [
    {"fps": 1, "min_argmin": 1, "fusion_chain": 1, "smallest_k": 1,
     "scatter_max": 2},
    {"fps": 0, "min_argmin": 0, "fusion_chain": 0, "smallest_k": 0,
     "scatter_max": 0},
    {"fps": 2, "min_argmin": 5, "fusion_chain": 0, "smallest_k": 1,
     "scatter_max": 2}])
def test_capture_takes_its_launches_off_and_each_replay_adds_them(made):
    """``take_launches`` returns what a capture counted and sets the
    counts back; ``add_launches`` adds it once a replay."""
    counts = {"fps": 7, "min_argmin": 3, "fusion_chain": 0, "smallest_k": 2,
              "scatter_max": 4}
    before = dict(counts)
    kernels.add_launches(counts, made)          # the capture's launches
    assert kernels.take_launches(counts, before) == made
    assert counts == before
    for _ in range(3):
        kernels.add_launches(counts, made)
    assert counts == {k: before[k] + 3 * made[k] for k in counts}


def _window(gaps, window_s=2.0):
    trace = None if gaps is None else {
        "busy_s": window_s - sum(s for _, s in gaps), "window_s": window_s,
        "device_ops": [], "idle_gaps": [list(g) for g in gaps],
        "kernel_s": {}}
    return harness.Window(wall_s=1.0, work=8, spans_s={}, events_ms={},
                          trace=trace)


@pytest.mark.parametrize("gaps,want", [
    (None, None),
    # the eager forward's spans (a program without the replay span)
    ([("usip.infer.trunk", 0.6), ("usip.infer.nodes", 0.2),
      ("benchmark.to_host", 0.05)], None),
    ([("usip.infer.replay", 0.1), ("usip.infer.nodes", 0.05),
      ("benchmark.to_host", 0.05)], 5.0)])
def test_the_replay_reader(gaps, want):
    """``idle_in.replay.detect``: the idle share in ``usip.infer.replay``,
    None without a trace or without that span."""
    got = harness.metric_reader("idle_in.replay.detect")(_window(gaps))
    assert got == (None if want is None else pytest.approx(want))


def test_the_replay_reader_is_an_entry_of_the_detect_cell():
    m = {m["name"]: m for m in harness.spec()["per_layer"]}[
        "idle_in.replay.detect"]
    assert m == {"name": "idle_in.replay.detect", "unit": "%",
                 "better": "lower", "source": "device_trace",
                 "layer": "eval forward", "moves": "detect_clouds_per_s",
                 "workloads": ["kitti-som.detect"]}
