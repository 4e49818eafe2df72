"""The port's data parallelism (``usip_tpu_torch.parallel.mesh``,
``BatchNorm(process_group=)``, the steps, engines and export under a data
mesh) at 2 gloo ranks on the CPU, against usip_tpu on a mesh of the same
size (``make_mesh(2)`` of the 8 virtual CPU devices) and against the port's
own one-rank functions, with usip_tpu's draws and weights.

One spawn of 2 ranks (``torch_dist_common.parallel_checks``) computes every
multi-rank result; the tests compare them. Tolerances: fp32 losses and
metrics 1e-5 relative (``grad_norm`` 1e-4 against usip_tpu, whose
gradients the port holds within 1e-4 x max|g|); the 2-rank gradients within
1e-5 x max|g| of the one-rank step's; BatchNorm running statistics 2e-5
(fp32 cancellation in ``E[x^2] - E[x]^2``); replicas bit-identical; export
trees byte-identical.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import test_torch_descriptor_train as TD
import test_torch_train as TT
from torch_dist_common import parallel_checks, param_hash, run_ranks
from usip_tpu.nn.layers import BatchNorm as JaxBatchNorm
from usip_tpu.parallel import make_mesh as jax_make_mesh
from usip_tpu.parallel import replicate as jax_replicate
from usip_tpu.parallel import shard_batch as jax_shard_batch
from usip_tpu.train import steps as jsteps
from usip_tpu.train.state import TrainState as JaxTrainState
from usip_tpu.train.state import make_adam as jax_make_adam
from usip_tpu_torch.config import get_config
from usip_tpu_torch.nn.layers import BatchNorm
from usip_tpu_torch.parallel import mesh as pmesh
from usip_tpu_torch.train import TrainState, steps
from usip_tpu_torch.train.checkpoint import save_checkpoint
from usip_tpu_torch.train.loop import DetectorEngine, init_detector_state

torch.set_num_threads(1)

RANKS = 2
ENGINE = {"data.input_pc_num": 128, "data.node_num": 16,
          "detector.c1": 16, "detector.c2": 32, "detector.node_knn_k": 4,
          "detector.compute_dtype": "float32", "train.batch_size": 4,
          "train.num_devices": RANKS, "train.log_every": 1}
ENGINE_DESC = {**ENGINE, "descriptor.descriptor_len": 16,
               "descriptor.ball_nsamples": 8,
               "descriptor.compute_dtype": "float32",
               "descriptor.ball_compute_dtype": "float32"}


def _rel(a, b, rtol, what):
    np.testing.assert_allclose(float(a), float(b), rtol=rtol, atol=1e-7,
                               err_msg=what)


def _bn_payload():
    rng = np.random.default_rng(3)
    x = rng.normal(2.0, 1.5, (8, 5, 6)).astype(np.float32)
    return {"bn_x": torch.from_numpy(x),
            "bn_w": torch.from_numpy(rng.uniform(0.5, 1.5, 6).astype(
                np.float32)),
            "bn_b": torch.from_numpy(rng.normal(size=6).astype(np.float32)),
            "bn_up": torch.from_numpy(rng.normal(size=x.shape).astype(
                np.float32))}


def _det_payload():
    jcfg, cfg, pc, sn, jmodel, variables, det = TT._setup()
    key, epoch = jax.random.PRNGKey(12), 3
    draws = TT._jax_draws(key, jcfg)
    eval_draws = TT._jax_draws(jax.random.PRNGKey(5), jcfg, train=False)
    return ({"overrides": TT.OVERRIDES, "state_dict": det.state_dict(),
             "pc": torch.from_numpy(pc), "sn": torch.from_numpy(sn),
             "draws": draws, "eval_draws": eval_draws, "epoch": epoch},
            (jcfg, jmodel, variables, key))


def _desc_payload(overrides, use_cgf):
    jcfg, cfg, batch, (jdet, det_vars), (jdesc, desc_vars), det, desc = \
        TD._setup(overrides)
    key, epoch = jax.random.PRNGKey(4), 3
    draws = TD._jax_draws(key, cfg, use_cgf)
    return ({"overrides": overrides, "det": det.state_dict(),
             "desc": desc.state_dict(),
             "batch": tuple(TD._t(x) for x in batch), "draws": draws,
             "epoch": epoch},
            (jcfg, batch, jdet, det_vars, jdesc, desc_vars, key))


def _export_payload(root):
    cfg = get_config("kitti", **ENGINE)
    state = init_detector_state(cfg, 0, "cpu")
    ckpt = os.path.join(root, "export.pt")
    save_checkpoint(ckpt, state)
    # node draws of the global batches (16 synthetic frames, batch 4)
    gen = torch.Generator().manual_seed(9)
    sub = max(cfg.data.node_num,
              cfg.data.input_pc_num // cfg.data.fps_subsample_ratio)
    draws = [(torch.rand((4, cfg.data.input_pc_num), generator=gen)
              .argsort(1)[:, :sub],
              torch.randint(0, sub, (4,), generator=gen).int())
             for _ in range(4)]
    return {"overrides": ENGINE, "checkpoint": ckpt, "root": root,
            "desired": 16, "node_draws": draws}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The payload, the references' inputs, and both ranks' results."""
    root = str(tmp_path_factory.mktemp("dp"))
    det, det_ref = _det_payload()
    scan, scan_ref = _desc_payload(TD.OVERRIDES, False)
    cgf, cgf_ref = _desc_payload(TD.CGF, True)
    payload = {**_bn_payload(), "det": det, "scan": scan, "cgf": cgf,
               "engine": {"overrides": ENGINE, "desc_overrides": ENGINE_DESC,
                          "root": os.path.join(root, "engine")},
               "export": _export_payload(root)}
    results = run_ranks(parallel_checks, RANKS, os.path.join(root, "ranks"),
                        payload)
    return payload, {"det": det_ref, "scan": scan_ref, "cgf": cgf_ref}, results


# ---------------------------------------------------------------- mesh ----

def test_mesh_rows_and_replicate(ranks):
    _, _, results = ranks
    for r, res in enumerate(results):
        assert res["mesh"] == (RANKS, r, slice(4 * r, 4 * r + 4))
        assert res["shard"].tolist() == list(range(4 * r, 4 * r + 4))
    # rank 1 started from other weights: replicate gave it rank 0's
    assert results[0]["replicate"] == results[1]["replicate"]


def test_initialize_distributed_without_environment_stays_single(
        caplog, monkeypatch):
    """No coordinator and no torchrun environment: a logged no-op, as
    usip_tpu's; the mesh is then one rank."""
    import logging
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with caplog.at_level(logging.INFO, logger="usip_tpu_torch.parallel.mesh"):
        pmesh.initialize_distributed(device="cpu")
    assert any("staying single-process" in r.message for r in caplog.records)
    assert not pmesh.is_distributed()
    mesh = pmesh.make_mesh(device="cpu")
    assert (mesh.size, mesh.rank) == (1, 0)
    with pytest.raises(ValueError, match="2 ranks|has 1 ranks"):
        pmesh.make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="together"):
        pmesh.initialize_distributed("127.0.0.1:1", device="cpu")


def test_cuda_mesh_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pmesh.make_mesh(device="cuda")


# ----------------------------------------------------------- BatchNorm ----

def _jax_bn_over_mesh(p):
    """usip_tpu's BatchNorm with ``axis_name`` over make_mesh(2), train
    mode, momentum 0.3: the outputs and the running statistics."""
    mesh = jax_make_mesh(RANKS)
    c = p["bn_x"].shape[-1]
    jbn = JaxBatchNorm(c, axis_name="data")
    variables = {"params": {"scale": jnp.asarray(p["bn_w"].numpy()),
                            "bias": jnp.asarray(p["bn_b"].numpy())},
                 "batch_stats": {"mean": jnp.zeros(c), "var": jnp.ones(c)}}

    def f(v, x):
        y, mut = jbn.apply(v, x, False, 0.3, mutable=["batch_stats"])
        return y, mut["batch_stats"]["mean"], mut["batch_stats"]["var"]

    run = jax.shard_map(f, mesh=mesh, in_specs=(P(), P("data")),
                        out_specs=(P("data"), P(), P()), check_vma=False)
    return run(variables, jnp.asarray(p["bn_x"].numpy()))


def test_batchnorm_over_ranks_matches_usip_tpu_and_one_rank(ranks):
    """BatchNorm(process_group=) at 2 ranks: outputs within 1e-5 of
    usip_tpu's ``axis_name`` BatchNorm on make_mesh(2) and of the port's
    one-rank layer on the whole batch; the running statistics within
    2e-5; the input's and the parameters' gradients (the statistics'
    backward crossing ranks) within 1e-5 of the one-rank layer's."""
    p, _, results = ranks
    x = p["bn_x"].clone().requires_grad_(True)
    bn = BatchNorm(x.shape[-1]).train()
    bn.momentum = 0.3
    with torch.no_grad():
        bn.weight.copy_(p["bn_w"])
        bn.bias.copy_(p["bn_b"])
    y = bn(x)
    (y * p["bn_up"]).sum().backward()
    jy, jmean, jvar = _jax_bn_over_mesh(p)
    got_y = torch.cat([r["bn"]["y"] for r in results])
    got_dx = torch.cat([r["bn"]["dx"] for r in results])
    np.testing.assert_allclose(got_y.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(got_y.numpy(), y.detach().numpy(), atol=1e-5)
    np.testing.assert_allclose(got_dx.numpy(), x.grad.numpy(), atol=1e-5)
    for res in results:
        b = res["bn"]
        for got, ref in ((b["mean"], jmean), (b["var"], jvar),
                         (b["mean"], bn.running_mean),
                         (b["var"], bn.running_var)):
            np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                       rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(b["dw"].numpy(), bn.weight.grad.numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(b["db"].numpy(), bn.bias.grad.numpy(),
                                   rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------- steps ----

def _check_against_one_rank(res, model, metrics, rtol_jax, jmetrics):
    """Metrics, gradients, running statistics and parameters of a 2-rank
    step against the one-rank step (``model`` after it) and usip_tpu's
    metrics on make_mesh(2)."""
    assert set(res["metrics"]) == set(metrics)
    for k, v in metrics.items():
        _rel(res["metrics"][k], v, 1e-5, k)
        if k in jmetrics:
            _rel(res["metrics"][k], jmetrics[k],
                 1e-4 if k == "grad_norm" else rtol_jax, k)
    grads = {n: p.grad for n, p in model.named_parameters()}
    gmax = max(float(g.abs().max()) for g in grads.values())
    assert gmax > 0
    for n, g in grads.items():
        err = float((res["grads"][n] - g).abs().max())
        assert err <= 1e-5 * gmax, (n, err, gmax)
    for n, t in model.state_dict().items():
        got = res["state"][n]
        if n.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got.numpy(), t.numpy(), rtol=2e-5,
                                       atol=2e-5, err_msg=n)
        elif not n.endswith("num_batches_tracked"):
            # Adam's first step moves a parameter by lr in the direction
            # of its gradient's sign: where the gradient is well above
            # the ranks' summation noise the parameters agree
            sure = (grads[n].abs() > 1e-3 * gmax).numpy()
            np.testing.assert_allclose(got.numpy()[sure], t.numpy()[sure],
                                       rtol=0, atol=1e-5, err_msg=n)


def test_detector_step_over_ranks(ranks):
    """The data-parallel detector step at 2 ranks (each its row of a
    2-cloud batch, usip_tpu's draws for the whole batch) against the
    one-rank step and usip_tpu's step on make_mesh(2); the replicas
    bit-identical after it."""
    p, refs, results = ranks
    d = p["det"]
    jcfg, jmodel, variables, key = refs["det"]
    mesh = jax_make_mesh(RANKS)
    jstate = jax_replicate(mesh, JaxTrainState.create(
        variables, jax_make_adam(jcfg.train.lr)))
    jbatch = jsteps.ParentBatch(*jax_shard_batch(
        mesh, (d["pc"].numpy(), d["sn"].numpy())))
    _, jm = jax.jit(jsteps.make_detector_train_step(jcfg, jmodel))(
        jstate, jbatch, key, jnp.asarray(d["epoch"]))

    cfg = get_config("kitti", **d["overrides"])
    det = init_detector_state(cfg).model
    det.load_state_dict(d["state_dict"])
    state = TrainState.create(det, cfg.train.lr)
    m = steps.make_detector_train_step(cfg)(
        state, steps.ParentBatch(d["pc"], d["sn"]), d["epoch"],
        draws=d["draws"])
    metrics = {k: float(v) for k, v in m.items()}
    for res in results:
        _check_against_one_rank(res["det"], det, metrics, 1e-5,
                                {k: float(v) for k, v in jm.items()})
    assert results[0]["det"]["hash"] == results[1]["det"]["hash"]
    # the eval step over the ranks gives the one-rank metrics
    det.load_state_dict(d["state_dict"])
    ev = steps.make_detector_eval_step(cfg)(
        TrainState.create(det, cfg.train.lr),
        steps.ParentBatch(d["pc"], d["sn"]), draws=d["eval_draws"])
    for res in results:
        for k, v in ev.items():
            _rel(res["det_eval"][k], v, 1e-5, k)


@pytest.mark.parametrize("name", ["scan", "cgf"])
def test_descriptor_step_over_ranks(ranks, name):
    """The data-parallel descriptor step (scan triplet with negatives on
    the other rank, and CGF) at 2 ranks against the one-rank step and
    usip_tpu's step on make_mesh(2); replicas bit-identical."""
    p, refs, results = ranks
    d = p[name]
    use_cgf = name == "cgf"
    jcfg, batch, jdet, det_vars, jdesc, desc_vars, key = refs[name]
    mesh = jax_make_mesh(RANKS)
    jstate = jax_replicate(mesh, JaxTrainState.create(
        desc_vars, jax_make_adam(jcfg.train.lr)))
    det_state = jax_replicate(mesh, JaxTrainState.create(
        det_vars, jax_make_adam(1e-3)))
    jbatch = jsteps.DescriptorBatch(*jax_shard_batch(mesh, batch[:4]),
                                    jnp.asarray(batch[4]))
    _, jm = jax.jit(jsteps.make_descriptor_train_step(
        jcfg, jdet, jdesc, use_cgf=use_cgf))(
        jstate, det_state, jbatch, key, jnp.asarray(d["epoch"]))

    cfg = get_config("kitti", role="descriptor", **d["overrides"])
    from usip_tpu_torch.models import Descriptor, Detector
    det = Detector(cfg.detector)
    det.load_state_dict(d["det"])
    desc = Descriptor(cfg.descriptor)
    desc.load_state_dict(d["desc"])
    state = TrainState.create(desc, cfg.train.lr)
    m = steps.make_descriptor_train_step(cfg, use_cgf)(
        state, det, steps.DescriptorBatch(*d["batch"]), d["epoch"],
        draws=d["draws"])
    metrics = {k: float(v) for k, v in m.items()}
    assert metrics["loss"] > 0
    for res in results:
        _check_against_one_rank(res[name], desc, metrics, 1e-5,
                                {k: float(v) for k, v in jm.items()})
    assert results[0][name]["hash"] == results[1][name]["hash"]


def test_draws_of_a_generator_are_the_steps_own():
    """A step handed ``detector_draws`` / ``descriptor_draws``' record of a
    generator equals the step handed the generator, bit for bit: the steps
    draw through those functions alone (the invariant that gives R ranks
    the one-rank run's draws, row for row)."""
    jcfg, cfg, pc, sn, jmodel, variables, det = TT._setup()
    batch = steps.ParentBatch(torch.from_numpy(pc), torch.from_numpy(sn))
    sd = {k: v.clone() for k, v in det.state_dict().items()}
    out = []
    for use_draws in (False, True):
        det.load_state_dict(sd)
        gen = torch.Generator().manual_seed(21)
        draws = steps.detector_draws(cfg, pc.shape[0], sn.shape[-1], gen,
                                     True, pc.shape[1]) if use_draws else None
        m = steps.make_detector_train_step(cfg)(
            TrainState.create(det, cfg.train.lr), batch, 2,
            draws=draws, generator=None if use_draws else gen)
        out.append(({k: float(v) for k, v in m.items()},
                    param_hash(det)))
    assert out[0] == out[1]

    jcfg, cfg, dbatch, _, _, det, desc = TD._setup(TD.CGF)
    dbatch = steps.DescriptorBatch(*(TD._t(x) for x in dbatch))
    sd = {k: v.clone() for k, v in desc.state_dict().items()}
    out = []
    for use_draws in (False, True):
        desc.load_state_dict(sd)
        gen = torch.Generator().manual_seed(22)
        draws = steps.descriptor_draws(cfg, 2, dbatch.anc_pc.shape[1], gen,
                                       True) if use_draws else None
        m = steps.make_descriptor_train_step(cfg, True)(
            TrainState.create(desc, cfg.train.lr), det, dbatch, 2,
            draws=draws, generator=None if use_draws else gen)
        out.append(({k: float(v) for k, v in m.items()}, param_hash(desc)))
    assert out[0] == out[1]


def test_draws_rows_cut_per_cloud_draws():
    cfg = get_config("kitti", **{**TT.OVERRIDES, "data.fps_parallel": 2})
    d = steps.detector_draws(cfg, 4, 4, torch.Generator().manual_seed(0),
                             True, TT.P)
    half = steps.draws_rows(d, slice(2, 4), 4)
    assert torch.equal(half.nodes_src.subset_idx, d.nodes_src.subset_idx[2:])
    per = d.nodes_src.first.shape[0] // 4
    assert torch.equal(half.nodes_src.first, d.nodes_src.first[2 * per:])
    assert half.dropout is d.dropout
    assert torch.equal(half.se3.angles, d.se3.angles[2:])
    assert torch.equal(half.shared.jitter[1][0], d.shared.jitter[1][0][2:])


# ------------------------------------------------------------- engines ----

def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_engines_over_ranks_write_once_and_resume(ranks):
    """DetectorEngine at 2 ranks: one epoch, rank 0's checkpoint and one
    metrics record a step (not one a rank), ``resume`` on every rank from
    the same file, a second epoch; the ranks identical throughout; the
    first step's loss the one-rank engine's on the same data and seeds.
    DescriptorEngine one epoch at 2 ranks."""
    p, _, results = ranks
    e0, e1 = (r["engines"] for r in results)
    assert e0 == e1
    assert e0["start"] == 1 and e0["resumed"]
    assert e0["step"] == 2 * 8 // ENGINE["train.batch_size"]
    assert e0["desc_step"] > 0
    out = os.path.join(p["engine"]["root"], "det")
    assert {"config.json", "last.pt", "last.pt.json",
            "train_metrics.jsonl"} <= set(os.listdir(out))
    assert not [f for f in os.listdir(out) if f.endswith(".tmp")]
    recs = _records(os.path.join(out, "train_metrics.jsonl"))
    steps_logged = [r["step"] for r in recs if r["prefix"] == "train"]
    assert steps_logged == sorted(set(steps_logged))  # no rank wrote twice
    assert [r["epoch"] for r in recs if r["prefix"] == "train_epoch"] == [0, 1]

    from usip_tpu_torch.data.pipeline import BatchLoader
    from usip_tpu_torch.data.synthetic import SyntheticDataset
    cfg = get_config("kitti", **{**ENGINE, "train.num_devices": 1})
    ds = SyntheticDataset(size=8, input_pc_num=128, surface_normal_len=4,
                          seed=0)
    one = os.path.join(p["engine"]["root"], "one")
    eng = DetectorEngine(cfg, BatchLoader(ds, 4, shuffle=True, num_workers=1),
                         None, out_dir=one, device="cpu")
    eng.train_epoch(0)
    first = [r for r in recs if r["prefix"] == "train"][0]
    ref = [r for r in _records(os.path.join(one, "train_metrics.jsonl"))
           if r["prefix"] == "train"][0]
    for k in ("loss", "chamfer", "keypoint_on_pc", "sigma_mean"):
        _rel(first[k], ref[k], 1e-5, k)


def test_engine_refuses_a_batch_that_does_not_split(monkeypatch):
    monkeypatch.setattr(pmesh, "world_size", lambda: 2)
    cfg = get_config("kitti", **{**ENGINE, "train.batch_size": 3})
    with pytest.raises(ValueError, match="does not split"):
        DetectorEngine(cfg, [], device="cpu")


# -------------------------------------------------------------- export ----

def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def test_export_over_ranks(ranks):
    """run_export at 2 ranks (global batch 4): the tree byte-identical to
    a one-rank export at the per-rank batch size 2; with the global
    batches' node draws, the keypoints within 1e-5 of a one-rank export at
    batch 4 with the same draws (here equal bit for bit)."""
    from usip_tpu_torch.eval.export_runner import run_export
    p, _, results = ranks
    e = p["export"]
    cfg = get_config("kitti", **{**ENGINE, "train.num_devices": 1})
    one = os.path.join(e["root"], "one")
    stats = run_export(cfg, e["checkpoint"], one, desired_num=e["desired"],
                       synthetic=True, batch_size=2, device="cpu")
    ranked = _tree(os.path.join(e["root"], "export_ranks"))
    assert len(ranked) == stats["frames"] == results[0]["export"][0]["frames"]
    assert ranked == _tree(one)
    whole = os.path.join(e["root"], "whole")
    run_export(cfg, e["checkpoint"], whole, desired_num=e["desired"],
               synthetic=True, batch_size=4, device="cpu",
               node_draws=lambda i: e["node_draws"][i])
    drawn = _tree(os.path.join(e["root"], "export_ranks_drawn"))
    ref = _tree(whole)
    assert drawn.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(np.frombuffer(drawn[k], np.float32),
                                   np.frombuffer(ref[k], np.float32),
                                   atol=1e-5, err_msg=k)


def test_cli_starts_the_ranks(ranks, capfd):
    """``export-keypoints --num-devices 2 --device cpu`` starts 2 gloo
    ranks itself (the global batch 4 split over them) and writes the tree
    of one rank at the per-rank batch 2, byte for byte; rank 0 alone
    prints the summary."""
    from usip_tpu_torch import cli
    p, _, _ = ranks
    e = p["export"]
    flags = ["export-keypoints", "--dataset", "kitti", "--synthetic",
             "--device", "cpu", "--checkpoint", e["checkpoint"],
             "--num-keypoints", "16"]
    for k, v in ENGINE.items():
        if k not in ("train.num_devices", "train.batch_size"):
            flags += ["--override", f"{k}={v}"]
    two = os.path.join(e["root"], "cli_two")
    cli.main(flags + ["--out", two, "--num-devices", "2", "--batch-size",
                      "4"])
    one = os.path.join(e["root"], "cli_one")
    cli.main(flags + ["--out", one, "--batch-size", "2"])
    assert _tree(two) and _tree(two) == _tree(one)
    # one summary line from the two ranks' run (rank 0's), one from one rank
    lines = [json.loads(x) for x in capfd.readouterr().out.splitlines()
             if x.startswith("{")]
    assert [x["frames"] for x in lines] == [len(_tree(two))] * 2
