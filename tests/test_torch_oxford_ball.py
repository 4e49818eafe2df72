"""The released Oxford ball detector's training as the ``oxford-ball.train``
cell runs it: the configuration file against the port's ``Config``, the
seeded Oxford tree through ``OxfordDataset``'s native path, the port's
ball-detector train step against the plain reference
(``benchmark/reference/ball_detector.py``), tiny CPU runs of the cell with
planted faults, and the grouped trunk's spans.

On the card (the ``cuda`` marker; they skip elsewhere; on a GPU host, where
jax is absent, run them without the suite's conftest: ``python -m pytest
--noconftest -m cuda tests/test_torch_oxford_ball.py``): a ball step's K4
and BatchNorm launches, eager and replayed, and its trace's K4 forms.
"""

import argparse
import json
import os
import time

import numpy as np
import pytest
import torch

from benchmark import compare, harness
from benchmark.data import oxford_scans
from benchmark.mixes import oxford_train_engine as mix
from benchmark.reference import ball_detector as bd
from benchmark.weights import PORT_KEYS, make_tensors, port_config
from usip_tpu_torch.config import get_config
from usip_tpu_torch.data.loaders import OxfordDataset, ParentCloudDataset
from usip_tpu_torch.ops import kernels
from usip_tpu_torch.train.loop import init_detector_state
from usip_tpu_torch.train.steps import (ParentBatch,
                                        _prepare_detector_inputs,
                                        make_detector_train_step)
from usip_tpu_torch.utils.logging import recording

CELL = "oxford-ball.train"
SPANS = ["usip.trunk.ball_query", "usip.trunk.group_features"]


def _file():
    return harness.config_file(harness.spec(), "oxford-ball")


def _tiny_file(points=640):
    """The cell's configuration at a small width, fp32: 2 parents of
    ``points`` sampled to 512, 32 nodes over half of each copy, c1 16, c2
    32, balls of 16 in 2 m."""
    config = _file()
    config["sizes"].update(input_pc_num=512, parent_pc_num=points,
                           node_num=32, fps_subsample_ratio=2, c1=16, c2=32,
                           node_knn_k=4, batch_size=2, group_k=16,
                           compute_dtype="float32")
    return config


def _tree(root, seed=5, traversals=2, submaps=3, points=640):
    """A small tree: submaps within 15 m, so that 2 m balls of 16 hold
    from a few points to more than 16."""
    oxford_scans.write_tree(str(root), seed, traversals, submaps, points,
                            scan_radius=15.0)
    return str(root)


def test_config_file_is_the_ported_preset():
    """The file states the Oxford preset with the ball trunk, key for key
    (nothing cut), and every key of it reaches the port's ``Config``."""
    config = _file()
    cfg = port_config(config, **mix.port_overrides(config))
    assert cfg == get_config("oxford", **{"detector.grouping": "ball"})
    assert (config["preset"], config["role"], config["reduced"]) == (
        "oxford", "detector", [])
    keys = {**PORT_KEYS, **mix.GROUP_KEYS}
    for key, value in config["sizes"].items():
        section, field = keys[key].split(".")
        assert getattr(getattr(cfg, section), field) == value, key
    for key, value in config["augment"].items():
        if key != "rotation":
            section, field = mix.AUGMENT_KEYS[key].split(".")
            assert getattr(getattr(cfg, section), field) == value, key
    assert cfg.augment.rot_type == "2d" and cfg.augment.height_scale


def _flip_back(pc):
    """Camera axes -> the submap's ENU axes (x, z, -y)."""
    return np.stack([pc[..., 0], pc[..., 2], -pc[..., 1]], -1)


def test_tree_through_the_native_loader(tmp_path):
    """Parent batches of the expected shapes in fp32, each parent a
    permutation of its submap's rows after the ENU-to-camera flip; the same
    seed writes the same files, and a dataset of the same seed gives the
    same rows (a dataset draws each batch anew)."""
    from usip_tpu_torch import native
    assert native.available()
    root = _tree(tmp_path / "a")
    again = _tree(tmp_path / "b")
    files = sorted(os.listdir(os.path.join(root, "train_np_nofilter")))
    assert len(files) == 6
    for f in files:
        a = np.load(os.path.join(root, "train_np_nofilter", f))
        assert a.shape == (640, 8) and a.dtype == np.float32
        assert np.array_equal(a, np.load(os.path.join(
            again, "train_np_nofilter", f)))
    cfg = port_config(_tiny_file(), **mix.port_overrides(_tiny_file()),
                      **{"data.dataroot": root})
    ds, twin = (ParentCloudDataset(OxfordDataset(cfg.data, "train",
                                                 sn_len=4, seed=3))
                for _ in range(2))
    assert len(ds) == 6
    batch = ds.get_batch([4, 0, 2], offset=7)
    assert batch["pc"].shape == (3, 640, 3)
    assert batch["sn"].shape == (3, 640, 4)
    assert batch["pc"].dtype == batch["sn"].dtype == np.float32
    for row, i in enumerate([4, 0, 2]):
        a = np.load(os.path.join(root, "train_np_nofilter", f"{i}.npy"))
        got = np.concatenate([_flip_back(batch["pc"][row]),
                              _flip_back(batch["sn"][row][:, :3]),
                              batch["sn"][row][:, 3:]], 1)
        assert np.array_equal(np.unique(got, axis=0), np.unique(a[:, :7],
                                                                axis=0))
    same = twin.get_batch([4, 0, 2], offset=7)
    assert all(np.array_equal(batch[k], same[k]) for k in batch)
    assert not np.array_equal(ds.get_batch([4], offset=7)["pc"][0],
                              batch["pc"][0])


def _parents(root, cfg, count):
    ds = ParentCloudDataset(OxfordDataset(cfg.data, "train", sn_len=4,
                                          seed=3))
    out = []
    for i in range(count):
        b = ds.get_batch([2 * i, 2 * i + 1], offset=i)
        out.append((torch.from_numpy(b["pc"]), torch.from_numpy(b["sn"])))
    return out


def test_ball_step_follows_the_reference(tmp_path):
    """The port's eager fp32 ball-detector step against the reference's, 3
    steps from the same seeded weights, parents and draws.

    Tolerances, each with its reason:

    * the balls: identical indices (both scan the same prepared clouds in
      index order; some balls are short of k and pad cyclically);
    * the prepared clouds within 1e-5 m: the two compose the same rotation,
      jitter and scales in another order of fp32 operations;
    * the first step's loss within 1e-4 of itself: the port's
      keypoint-to-cloud and chamfer distances are the square roots of
      ``|a|^2 - 2 a.b + |b|^2``, whose cancellation over coordinates of
      tens of metres moves a small distance by ~1e-3 of itself (4e-6
      observed); the later steps' within 3e-3, after Adam's steps below
      (1.1e-3 observed);
    * each moving leaf's first gradient within 0.05 of the larger of its
      norm and the median leaf's: besides the distances, a max over a
      ball or over a node's neighbours whose two largest entries lie within
      fp32 round-off of each other sends the gradient to another row on
      either side (0.0008 to 0.028 over six draws of this test; the bf16
      trunk reads over 0.1); the leaves left out are those whose gradient
      is under 1e-3 of the median's (the biases before a BatchNorm, nought
      but round-off), as the cell leaves them out;
    * the parameters after 3 Adam steps within 6 lr of each other
      elementwise (Adam moves each element by at most about lr a step, on
      either side), and each moving leaf's change within 0.15 of the larger
      of its norm and the median's (0.03 to 0.072 over six draws): an
      element whose gradient lies within the two sides' gradient gap takes
      Adam's step of the other sign."""
    config = _tiny_file()
    z = bd.sizes_from(config)
    root = _tree(tmp_path)
    cfg = port_config(config, **mix.port_overrides(config),
                      **{"data.dataroot": root})
    batches = _parents(root, cfg, 3)
    gen = torch.Generator().manual_seed(9)
    draws = [mix.make_draws(z, config["augment"], gen) for _ in batches]
    weights = make_tensors(bd.param_shapes(z), 4, 1, "cpu", "init")
    state = init_detector_state(cfg, 0, "cpu")
    state.model.load_state_dict(weights)
    step = make_detector_train_step(cfg)
    losses, first, short, full = [], None, 0, 0
    for i, ((pc, sn), d) in enumerate(zip(batches, draws)):
        batch = ParentBatch(pc, sn)
        src, dst, _ = _prepare_detector_inputs(batch, cfg, True,
                                               mix.port_draws(d))
        ref_src, ref_dst, _ = bd.prepare(z, pc, sn, d)
        for a, b in zip(src + dst, ref_src + ref_dst):
            torch.testing.assert_close(a, b, rtol=0.0, atol=1e-5)
        cloud, node = torch.cat([src[0], dst[0]]), torch.cat([src[2], dst[2]])
        idx = state.model.group_indices(cloud, node).long()
        assert torch.equal(idx, bd.ball_indices(cloud, node, z))
        counts = bd.ball_counts(cloud, node, z)
        short += int((counts < z.group_k).sum())
        full += int((counts >= z.group_k).sum())
        metrics = step(state, batch, 0, draws=mix.port_draws(d))
        losses.append(float(metrics["loss"]))
        if i == 0:
            first = {n: p.grad.detach().clone()
                     for n, p in state.model.named_parameters()}
    assert short > 0 and full > 0
    ref = bd.train_steps(weights, z, batches, draws)
    assert losses[0] == pytest.approx(ref.losses[0], rel=1e-4)
    assert losses == pytest.approx(ref.losses, rel=3e-3)
    keep = compare.moving_leaves(ref.first_grads)
    assert len(keep) >= 35
    assert compare.worst_leaf_gap(first, ref.first_grads, keep) < 0.05
    after = {n: p.detach() for n, p in state.model.named_parameters()}
    for n, p in after.items():
        assert float((p - weights[n] - ref.change[n]).abs().max()) <= 6 * z.lr
    change = {n: after[n] - weights[n] for n in after}
    assert compare.worst_leaf_gap(change, ref.change, keep) < 0.15


def _tiny_context(tmp_env, seconds=0.5):
    """A CPU run's context of the cell at the tiny width (its own limits),
    over a tree of 4 parents of 640 points within 15 m."""
    config = _tiny_file()
    traffic = dict(harness.traffic_file("oxford-train"), traversals=2,
                   submaps=2, points=640, scan_radius=15.0)
    args = argparse.Namespace(workload=CELL, seed=2 ** 31 + 91,
                              seconds=seconds, trace=0)
    return harness.RunContext(args, time.perf_counter(), device="cpu",
                              config=config, traffic=traffic)


def _frozen(make):
    def factory(*args, **kwargs):
        step = make(*args, **kwargs)

        def faulty(state, *rest, **kw):
            before = [p.detach().clone() for p in state.model.parameters()]
            out = step(state, *rest, **kw)
            with torch.no_grad():
                for p, b in zip(state.model.parameters(), before):
                    p.copy_(b)
            return out
        return faulty
    return factory


def _half(make):
    def factory(*args, **kwargs):
        step = make(*args, **kwargs)

        def faulty(state, batch, epoch, *, draws=None, **kw):
            from usip_tpu_torch.train.steps import draws_rows
            b = batch[0].shape[0]
            if draws is not None:
                draws = draws_rows(draws, slice(0, b // 2), b)
            return step(state, ParentBatch(batch.pc[:b // 2],
                                           batch.sn[:b // 2]),
                        epoch, draws=draws, **kw)
        return faulty
    return factory


def _radius(ball_query):
    def faulty(points, centers, radius, k, *args, **kwargs):
        return ball_query(points, centers, 0.75 * radius, k, *args, **kwargs)
    return faulty


FAULTS = {
    "unchanged": ("usip_tpu_torch.train.loop", "make_detector_train_step",
                  _frozen),
    "half_batch": ("usip_tpu_torch.train.loop", "make_detector_train_step",
                   _half),
    "radius": ("usip_tpu_torch.models.detector", "ball_query", _radius),
}


@pytest.mark.parametrize("fault", [None] + sorted(FAULTS))
def test_tiny_run_of_the_cell(fault, monkeypatch, capsys):
    """A tiny CPU run of the cell through ``harness.run_mix``: ``correct``
    with the program as it is, and not with a state left unchanged, half of
    each batch left out, or balls of three quarters of the radius."""
    if fault is not None:
        import importlib
        path, name, plant = FAULTS[fault]
        module = importlib.import_module(path)
        monkeypatch.setattr(module, name, plant(getattr(module, name)))
    ctx = _tiny_context(fault)
    assert ctx.limits == harness.limits_file(CELL)
    line = harness.result_line(ctx, harness.run_mix(ctx))
    out = capsys.readouterr().out.strip().splitlines()
    fill = json.loads(next(x for x in out
                           if x.startswith("ball_fill "))[len("ball_fill "):])
    assert fill["balls"] == 3 * 4 * 32 and fill["empty_share"] < 1
    assert set(line["checks"]) == set(ctx.limits)
    assert line["attempted"] > 0 and line["metrics"] == {}
    assert line["correct"] is (fault is None), line["checks"]


def _step_spans(cfg):
    state = init_detector_state(cfg, 0, "cpu")
    g = torch.Generator().manual_seed(0)
    b, p = cfg.train.batch_size, cfg.data.parent_pc_num
    batch = ParentBatch(10 * torch.rand((b, p, 3), generator=g),
                        torch.rand((b, p, 4), generator=g))
    step = make_detector_train_step(cfg)
    with recording() as rec:
        step(state, batch, 0, generator=torch.Generator().manual_seed(1))
    return rec.names()


@pytest.mark.parametrize("grouping", ["ball", "som"])
def test_trunk_spans(grouping):
    """An eager ball step opens the ball query's and the group features'
    spans, inside its forward; a SOM step opens neither."""
    config = _tiny_file()
    over = {**mix.port_overrides(config), "detector.grouping": grouping}
    names = _step_spans(port_config(config, **over))
    assert "usip.step.forward" in names
    if grouping == "ball":
        assert [n for n in names if n.startswith("usip.trunk.")] == SPANS
        assert names.index("usip.step.forward") < names.index(SPANS[0])
        assert names.index(SPANS[1]) < names.index("usip.step.losses")
    else:
        assert not any(n.startswith("usip.trunk.") for n in names)


def test_flops_count_the_ball_trunk():
    """The cell's model FLOPs a cloud: the ball PointNet's 524288 rows a
    step outweigh no layer of the fusion and head by a factor of 10."""
    sizes = _file()["sizes"]
    total = bd.train_flops(sizes)
    ball = 3 * 2 * (512 * 64 * (7 * 64 + 2 * 64 * 64 + 64 * 128 + 128 * 128)
                    + 512 * 64 * 128)
    assert ball / total == pytest.approx(0.18, abs=0.01)
    assert mix.ball_select_ms(bd.sizes_from(_file())) == pytest.approx(
        0.1615, abs=5e-5)


# ----------------------------------------------------------------- card ----

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU build")
    return torch.device("cuda")


@pytest.mark.cuda
def test_ball_step_launches_on_the_card(dev):
    """At the cell's widths (8 parents of 20480 points), a ball step raises
    ``LAUNCHES["smallest_k"]`` by 2 (the balls, the node kNN) and
    ``["batch_norm"]`` by 84 (12 layers, 7 each), eagerly and under replay,
    and a replayed step's trace holds one ``smallest_k_block`` and one
    ``smallest_k_warp`` launch."""
    from torch.profiler import ProfilerActivity, profile
    config = _file()
    cfg = port_config(config, **mix.port_overrides(config))
    state = init_detector_state(cfg, 0, dev)
    g = torch.Generator(device=dev).manual_seed(0)
    batch = ParentBatch(20 * torch.rand((8, 20480, 3), generator=g,
                                        device=dev),
                        torch.rand((8, 20480, 4), generator=g, device=dev))
    step = make_detector_train_step(cfg)

    def launches(call):
        kernels.reset_launch_counts()
        call()
        torch.cuda.synchronize()
        return kernels.LAUNCHES["smallest_k"], kernels.LAUNCHES["batch_norm"]

    gen = lambda: torch.Generator(device=dev).manual_seed(5)  # noqa: E731
    inputs = _prepare_detector_inputs(batch, cfg, True, None, gen())
    assert launches(lambda: step(state, batch, 0, _inputs=inputs)) == (2, 84)
    step(state, batch, 0, generator=gen())             # the capture
    assert launches(lambda: step(state, batch, 0, generator=gen())) == (2, 84)
    assert step.graph_counts == {"captures": 1, "replays": 1, "eager": 1}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, batch, 0, generator=gen())
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("smallest_k_block" in n for n in names) == 1
    assert sum("smallest_k_warp" in n for n in names) == 1


@pytest.mark.cuda
def test_control_fails_where_the_program_passes(dev):
    """At the cell's own size, on three seeds: the program's numbers sit
    under the cell's limits, and the control's (the reference in float8 in
    the program's place) break at least one of them."""
    harness.cache_dirs()
    for seed in (2 ** 31 + 2201, 2 ** 31 + 2202, 2 ** 31 + 2203):
        args = argparse.Namespace(workload=CELL, seed=seed, seconds=2.0,
                                  trace=0)
        ctx = harness.RunContext(args, time.perf_counter())
        found = mix.calibration(ctx, True)
        limits = ctx.limits
        assert all(found["program"][k] <= v for k, v in limits.items()), found
        assert any(found["control"][k] > v for k, v in limits.items()), found
