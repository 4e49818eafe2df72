"""The port's point-sharded ops, detector, trainers and describe, tensor
parallelism and the detect -> describe pipeline
(``usip_tpu_torch.parallel.sharded_*``, ``tensor_parallel``,
``pipeline_parallel``) at 2 gloo ranks on the CPU (and 2-D grids at 4),
against usip_tpu on a mesh of the same size (``make_point_mesh(2)``,
``make_channel_mesh(2)`` of the 8 virtual CPU devices) and against the
port's one-rank functions.

Two spawns (``torch_dist_common.sharded_checks`` at 2 ranks,
``grid_checks`` at 4) compute every multi-rank result; the tests compare.
Tolerances, each stated where it is used: fp32 losses 1e-5 relative;
indices bit-identical (ties across shards included); gradients within
1e-5 x max|g| of the one-rank function's; BatchNorm running statistics
2e-5; the TP forward in bf16 within usip_tpu's ``test_tp_forward_bf16_close``
bound (0.05).
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_dist_common import grid_checks, run_ranks, sharded_checks
import test_torch_train as TT
from usip_tpu.config import get_config as jax_get_config
from usip_tpu.models import Descriptor as JaxDescriptor
from usip_tpu.models import Detector as JaxDetector
from usip_tpu.parallel import sharded_ops as jso
from usip_tpu.parallel.pipeline_parallel import pipeline_detect_describe \
    as jax_pipeline
from usip_tpu.parallel.sharded_descriptor import sharded_describe \
    as jax_sharded_describe
from usip_tpu.parallel.sharded_detector import sharded_detector_forward \
    as jax_sharded_detector_forward
from usip_tpu.parallel.sharded_train import (
    make_sharded_descriptor_train_step as jax_sharded_desc_step)
from usip_tpu.parallel.sharded_train import (
    make_sharded_detector_train_step as jax_sharded_det_step)
from usip_tpu.parallel import tensor_parallel as jtp
from usip_tpu.train import TrainState as JaxTrainState
from usip_tpu.train import make_adam as jax_make_adam
from usip_tpu_torch import losses
from usip_tpu_torch.config import get_config
from usip_tpu_torch.models import Descriptor, Detector
from usip_tpu_torch.models.fused_infer import detector_infer_fused
from usip_tpu_torch.ops import ball_query, gather_points, knn
from usip_tpu_torch.ops.geometry import apply_se3, nearest_neighbor
from usip_tpu_torch.parallel import pipeline_parallel as pp
from usip_tpu_torch.parallel import tensor_parallel as tpm
from usip_tpu_torch.parallel.sharded_train import (
    make_sharded_descriptor_train_step, sharded_trunk_apply)
from usip_tpu_torch.train import TrainState, steps
from usip_tpu_torch.weights import state_dict_from_jax, tp_params_from_jax

torch.set_num_threads(1)

RANKS = 2
# usip_tpu's tests' small SOM detector (tests/test_sharded_ops.py)
DET = {"data.input_pc_num": 256, "data.node_num": 16, "detector.c1": 16,
       "detector.c2": 32, "detector.node_knn_k": 4,
       "detector.compute_dtype": "float32", "train.batch_size": 2}
DESC = {**DET, "descriptor.descriptor_len": 16, "descriptor.ball_nsamples": 8,
        "descriptor.ball_radius": 1.5, "descriptor.surface_normal_len": 3,
        "descriptor.compute_dtype": "float32",
        "descriptor.ball_compute_dtype": "float32"}


def _t(x):
    return torch.from_numpy(np.array(x))


def _host(v):
    return jax.tree_util.tree_map(np.asarray, v)


def _mk(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _detector(overrides, seed=0, preset="modelnet"):
    """usip_tpu's Detector, its variables, and the port's holding them."""
    jcfg = jax_get_config(preset, **overrides)
    n, m = jcfg.data.input_pc_num, jcfg.data.node_num
    s = jcfg.detector.surface_normal_len
    jdet = JaxDetector(jcfg.detector)
    v = jdet.init(jax.random.PRNGKey(seed), jnp.zeros((2, n, 3)),
                  jnp.zeros((2, n, s)), jnp.zeros((2, m, 3)), train=False)
    det = Detector(get_config(preset, **overrides).detector)
    det.load_state_dict(state_dict_from_jax(_host(v)), strict=True)
    return jcfg, jdet, v, det


def _payload(rng):
    p, ref = {}, {}
    # chamfer, single side, min-dist with ties across the shards
    b, m, n = 2, 32, 64
    p["chamfer"] = {"src": _t(_mk(rng, b, m, 3)), "dst": _t(_mk(rng, b, n, 3)),
                    "ssig": _t(rng.uniform(0.5, 2, (b, m)).astype(np.float32)),
                    "dsig": _t(rng.uniform(0.5, 2, (b, n)).astype(np.float32))}
    pc = _mk(rng, 2, 128, 3)
    tied = pc.copy()
    tied[:, 64:96] = tied[:, 0:32]  # shard 1 repeats shard 0's first rows
    p["single"] = {"kp": _t(_mk(rng, 2, 8, 3)), "pc": _t(pc),
                   "pc_tied": _t(tied)}
    p["single"]["kp"][:, :4] = p["single"]["pc_tied"][:, 70:74]
    # knn on a tied database, as usip_tpu's test's shapes
    db = _mk(rng, 1, 64, 3)
    db[:, 32:48] = db[:, 0:16]
    p["knn"] = {"q": _t(_mk(rng, 1, 8, 3)), "db": _t(db),
                "f": _t(_mk(rng, 1, 64, 5)), "k": 4}
    # ball gather as usip_tpu's test, and with tied (coarse) priorities
    pts = _mk(rng, 2, 128, 3)
    pri = np.asarray(jax.random.uniform(jax.random.PRNGKey(3), (2, 128)))
    p["ball"] = {"centers": _t(pts[:, :8]), "pts": _t(pts),
                 "feats": _t(_mk(rng, 2, 128, 5)), "r": 0.8, "k": 6,
                 "pri": _t(pri), "pri_tied": _t(np.floor(pri * 4) / 4)}
    # the detector forward, the empty-on-one-rank case and a train step
    jcfg, jdet, v, det = _detector(DET)
    s = jcfg.detector.surface_normal_len
    pcd, snd, node = _mk(rng, 2, 256, 3), _mk(rng, 2, 256, s), \
        _mk(rng, 2, 16, 3)
    p["detector"] = {"overrides": DET, "state_dict": det.state_dict(),
                     "pc": _t(pcd), "sn": _t(snd), "node": _t(node)}
    ref["detector"] = (jcfg, jdet, v, det)
    # the cloud's two halves (one a rank) on two sides of x = 0; node 0
    # sits far out on the positive side: empty on rank 0, not on rank 1
    pe = np.abs(_mk(rng, 2, 256, 3))
    pe[:, :128, 0] *= -1
    nodes = np.concatenate([np.full((2, 1, 3), [4.0, 0.5, 0.5], np.float32),
                            pe[:, :15]], axis=1)
    p["empty"] = {"pc": _t(pe), "sn": _t(_mk(rng, 2, 256, s)),
                  "node": _t(nodes)}
    src_pc, dst_pc = _mk(rng, 2, 256, 3), _mk(rng, 2, 256, 3)
    src_sn, dst_sn = _mk(rng, 2, 256, s), _mk(rng, 2, 256, s)
    args = (src_pc, src_sn, src_pc[:, :16], dst_pc, dst_sn, dst_pc[:, :16],
            np.broadcast_to(np.eye(3, dtype=np.float32), (2, 3, 3)).copy(),
            np.ones(2, np.float32), np.zeros((2, 3), np.float32))
    p["train"] = {"args": tuple(_t(a) for a in args)}
    ref["train"] = args
    # describe (fp32; global context in bf16) with usip_tpu's priorities
    p["describe"] = {}
    for name, preset, ov in (
            ("fp32", "modelnet", {"descriptor.descriptor_len": 16,
                                  "descriptor.ball_nsamples": 8,
                                  "descriptor.ball_radius": 0.8,
                                  "descriptor.surface_normal_len": 3,
                                  "descriptor.compute_dtype": "float32",
                                  "descriptor.ball_compute_dtype": "float32"}),
            ("global_bf16", "match3d", {
                "descriptor.descriptor_len": 16, "descriptor.ball_nsamples": 8,
                "descriptor.ball_radius": 0.8,
                "descriptor.surface_normal_len": 3,
                "descriptor.use_global_context": True,
                "descriptor.compute_dtype": "bfloat16",
                "descriptor.ball_compute_dtype": "float32",
                "descriptor.ball_method": "exact"})):
        jc = jax_get_config(preset, **ov)
        dpc, dsn = _mk(rng, 2, 128, 3), _mk(rng, 2, 128, 3)
        jdesc = JaxDescriptor(jc.descriptor)
        key = jax.random.PRNGKey(5)
        dv = jdesc.init(jax.random.PRNGKey(0), dpc, dsn, dpc[:, :8], key=key,
                        train=False)
        desc = Descriptor(get_config(preset, **ov).descriptor)
        desc.load_state_dict(state_dict_from_jax(_host(dv)), strict=True)
        p["describe"][name] = {
            "preset": preset, "overrides": ov, "state_dict": desc.state_dict(),
            "pc": _t(dpc), "sn": _t(dsn), "kp": _t(dpc[:, :8]),
            "priority": _t(jax.random.uniform(key, (2, 128)))}
        ref["describe_" + name] = (jc, jdesc, dv, key)
    # the sharded descriptor step (usip_tpu's test's inputs)
    jc = jax_get_config("modelnet", **DESC)
    jdet2 = JaxDetector(jc.detector)
    a = (_mk(rng, 2, 256, 3), _mk(rng, 2, 256, 3))
    dets = jdet2.init(jax.random.PRNGKey(0), a[0], _mk(rng, 2, 256, 3),
                      a[0][:, :16], train=False)
    jdesc = JaxDescriptor(jc.descriptor)
    dvs = jdesc.init(jax.random.PRNGKey(1), a[0], _mk(rng, 2, 256, 3),
                     a[0][:, :16], key=jax.random.PRNGKey(2), train=False)
    anc_pc, pos_pc = a
    anc_sn, pos_sn = _mk(rng, 2, 256, 3), _mk(rng, 2, 256, 3)
    dargs = (anc_pc, anc_sn, anc_pc[:, :16], pos_pc, pos_sn, pos_pc[:, :16],
             np.array([1, 0]))
    key = jax.random.PRNGKey(7)
    k_a, k_p, _ = jax.random.split(key, 3)
    dcfg = get_config("modelnet", **DESC)
    pdet, pdesc = Detector(dcfg.detector), Descriptor(dcfg.descriptor)
    pdet.load_state_dict(state_dict_from_jax(_host(dets)), strict=True)
    pdesc.load_state_dict(state_dict_from_jax(_host(dvs)), strict=True)
    p["desc_train"] = {"overrides": DESC, "det": pdet.state_dict(),
                       "desc": pdesc.state_dict(),
                       "args": tuple(_t(x) for x in dargs),
                       "pri": (_t(jax.random.uniform(k_a, (2, 256))),
                               _t(jax.random.uniform(k_p, (2, 256))))}
    ref["desc_train"] = (jc, jdet2, dets, jdesc, dvs, dargs, key)
    # tensor parallelism: usip_tpu's test's forward setup, fp32 and bf16,
    # and a train step at the port's train-test width
    p["tp"] = {}
    for name, dt in (("fp32", "float32"), ("bf16", "bfloat16")):
        ov = {**DET, "detector.compute_dtype": dt}
        jc2, jd2, v2, d2 = _detector(ov, seed=0)
        s2 = jc2.detector.surface_normal_len
        inputs = (_mk(rng, 2, 256, 3), _mk(rng, 2, 256, s2),
                  _mk(rng, 2, 16, 3))
        p["tp"][name] = {"overrides": ov, "state_dict": d2.state_dict(),
                         "inputs": tuple(_t(x) for x in inputs)}
        ref["tp_" + name] = (jc2, jd2, v2, d2, inputs)
    jcfg_t, cfg_t, pct, snt, jmodel_t, vars_t, det_t = TT._setup(
        overrides={**TT.OVERRIDES, "detector.c2": 32})
    key_t = jax.random.PRNGKey(12)
    p["tp"]["train"] = {"overrides": {**TT.OVERRIDES, "detector.c2": 32},
                        "state_dict": det_t.state_dict(), "pc": _t(pct),
                        "sn": _t(snt), "epoch": 3,
                        "draws": TT._jax_draws(key_t, jcfg_t)}
    return p, ref


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sharded"))
    p, ref = _payload(np.random.default_rng(1234))
    grid = {"train": {"overrides": {**DET, "train.batch_size": 4},
                      "state_dict": p["detector"]["state_dict"],
                      "args": None},
            "tp": p["tp"]}
    rng = np.random.default_rng(7)
    s = ref["detector"][0].detector.surface_normal_len
    src_pc, dst_pc = _mk(rng, 4, 128, 3), _mk(rng, 4, 128, 3)
    grid["train"]["args"] = tuple(_t(a) for a in (
        src_pc, _mk(rng, 4, 128, s), src_pc[:, :16], dst_pc,
        _mk(rng, 4, 128, s), dst_pc[:, :16],
        np.broadcast_to(np.eye(3, dtype=np.float32), (4, 3, 3)).copy(),
        np.ones(4, np.float32), np.zeros((4, 3), np.float32)))
    two = run_ranks(sharded_checks, RANKS, os.path.join(root, "two"), p)
    four = run_ranks(grid_checks, 4, os.path.join(root, "four"), grid)
    return p, ref, two, four, grid


def _cat_shards(results, f, dim=1):
    return torch.cat([f(r) for r in results], dim=dim)


# ------------------------------------------------------------ sharded ops --

def test_sharded_chamfer_matches_usip_tpu_and_one_rank(ranks):
    """Loss and diagnostics rel 1e-5 of usip_tpu's on make_point_mesh(2)
    and of the one-rank chamfer; the gradient in src (each rank its
    rows) within 1e-5 x max|g| of the one-rank one."""
    p, _, two, _, _ = ranks
    c = p["chamfer"]
    jmesh = jso.make_point_mesh(RANKS)
    args = [jnp.asarray(c[k].numpy()) for k in ("src", "dst", "ssig", "dsig")]
    jout = jax.jit(lambda *a: jso.sharded_chamfer_probabilistic(
        jmesh, *a))(*args)
    src = c["src"].clone().requires_grad_(True)
    ref = losses.chamfer_probabilistic(src, c["dst"], c["ssig"], c["dsig"])
    ref.loss.backward()
    for res in two:
        o = res["chamfer"]
        for got, j, t in ((o["loss"], jout.loss, ref.loss),
                          (o["pure"], jout.chamfer_pure, ref.chamfer_pure),
                          (o["weighted"], jout.chamfer_weighted,
                           ref.chamfer_weighted)):
            np.testing.assert_allclose(float(got), float(j), rtol=1e-5)
            np.testing.assert_allclose(float(got), float(t.detach()),
                                       rtol=1e-5)
    g = _cat_shards(two, lambda r: r["chamfer"]["grad"])
    gmax = float(src.grad.abs().max())
    assert float((g - src.grad).abs().max()) <= 1e-5 * gmax


def test_sharded_single_side_and_min_dist(ranks):
    """Keypoint -> sharded cloud distances within 1e-5 of usip_tpu's and
    the one-rank op's, the gradient in the keypoints within 1e-5 x
    max|g|; ``sharded_min_dist``'s global argmin bit-identical to the
    one-rank nearest neighbour on a cloud whose shards repeat points
    (ties go to the lower global index)."""
    p, _, two, _, _ = ranks
    s = p["single"]
    jout = jso.sharded_single_side_chamfer(
        jso.make_point_mesh(RANKS), jnp.asarray(s["kp"].numpy()),
        jnp.asarray(s["pc"].numpy()))
    kp = s["kp"].clone().requires_grad_(True)
    ref = losses.single_side_chamfer(kp, s["pc"])
    ref.sum().backward()
    d_ref, idx_ref = nearest_neighbor(s["kp"], s["pc_tied"])
    for res in two:
        np.testing.assert_allclose(res["single"]["d"].numpy(),
                                   np.asarray(jout), atol=1e-5)
        np.testing.assert_allclose(res["single"]["d"].numpy(),
                                   ref.detach().numpy(), atol=1e-5)
        gmax = float(kp.grad.abs().max())
        assert float((res["single"]["grad"] - kp.grad).abs().max()) \
            <= 1e-5 * gmax
        d, idx = res["min_dist"]
        assert torch.equal(idx, idx_ref.long())
        np.testing.assert_allclose(d.numpy(), d_ref.numpy(), atol=1e-6)
    # the keypoints on repeated points resolve to shard 0's copies
    assert idx_ref[:, :4].tolist() == [[6, 7, 8, 9]] * 2


def test_sharded_knn_gather_matches(ranks):
    """Distances within 1e-4 of usip_tpu's sharded gather (its test's
    bound) and the features equal as sorted rows; against the one-rank
    ``knn`` on a database whose shards repeat rows: the merged global
    indices bit-identical (ties to the lower global index), distances and
    features exact."""
    p, _, two, _, _ = ranks
    k = p["knn"]
    jd, jf = jso.sharded_knn_gather(jso.make_point_mesh(RANKS),
                                    *(jnp.asarray(k[x].numpy())
                                      for x in ("q", "db", "f")), k["k"])
    d_ref, idx_ref = knn(k["q"], k["db"], k["k"])
    for res in two:
        d, f, idx = res["knn"]
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-4)
        np.testing.assert_allclose(np.sort(f.numpy(), axis=2),
                                   np.sort(np.asarray(jf), axis=2), atol=1e-5)
        assert torch.equal(idx, idx_ref.long())
        assert torch.equal(d, d_ref)
        assert torch.equal(f, gather_points(k["f"], idx_ref))


def test_sharded_ball_gather_matches(ranks):
    """Counts and features equal to usip_tpu's sharded ball gather (its
    test's priorities); indices bit-identical to the one-rank ball query
    with the same priorities, also with coarse, tied priorities."""
    p, _, two, _, _ = ranks
    b = p["ball"]
    jmesh = jso.make_point_mesh(RANKS)
    jf, jvalid, jc = jax.jit(lambda c, pt, f, pr: jso.sharded_ball_gather(
        jmesh, c, pt, f, b["r"], b["k"], pr))(
        *(jnp.asarray(b[k].numpy()) for k in ("centers", "pts", "feats",
                                               "pri")))
    for res in two:
        for i, pri in enumerate((b["pri"], b["pri_tied"])):
            feats, found, counts, idx = res["ball"][i]
            bq = ball_query(b["pts"], b["centers"], b["r"], b["k"], pri)
            assert torch.equal(counts, bq.counts)
            assert torch.equal(idx, bq.idx.long())
            assert torch.equal(feats, gather_points(b["feats"], bq.idx))
            if i == 0:
                np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
                np.testing.assert_array_equal(found.numpy(),
                                              np.asarray(jvalid))
                np.testing.assert_allclose(feats.numpy(), np.asarray(jf),
                                           atol=1e-6)


# ------------------------------------------------------- sharded detector --

def test_sharded_detector_forward_matches(ranks):
    """The sharded eval forward (its node part the fused chain) equals the
    one-rank serving forward within 1e-5; against usip_tpu's sharded
    forward (fp32, layered) the anchors within 1e-5 and the keypoints and
    sigmas within the fused chain's bf16 (2e-2: the chain rounds its
    operands to bf16)."""
    p, ref, two, _, _ = ranks
    t = p["detector"]
    jcfg, jdet, v, det = ref["detector"]
    jmesh = jso.make_point_mesh(RANKS)
    j = jax.jit(lambda *a: jax_sharded_detector_forward(jmesh, jcfg, *a))(
        v, *(jnp.asarray(t[k].numpy()) for k in ("pc", "sn", "node")))
    one = detector_infer_fused(det.eval(), t["pc"], t["sn"], t["node"])
    for res in two:
        for got, r1, rj, tol in zip(res["detector"], one, j,
                                    (1e-5, 2e-2, 2e-2)):
            np.testing.assert_allclose(got.numpy(), r1.numpy(), atol=1e-5)
            np.testing.assert_allclose(got.numpy(), np.asarray(rj), atol=tol)


def test_sharded_trunk_node_empty_on_one_rank(ranks):
    """A node whose points all lie on rank 1 (none on rank 0), with
    negative features there: the sharded trunk (the scatter-max kernel's
    local max, the rank without points at -inf, then the max over ranks)
    equals the one-rank trunk within 1e-5."""
    p, ref, two, _, _ = ranks
    e = p["empty"]
    det = ref["detector"][3].eval()
    anchors, feat = det.trunk(e["pc"], e["sn"], e["node"])
    c0, c1 = (r["empty"]["local_counts"] for r in two)
    assert (c0[:, 0] == 0).all() and (c1[:, 0] > 0).all()
    assert (feat[:, 0] < 0).any()
    for res in two:
        a, f = res["empty"]["trunk"]
        np.testing.assert_allclose(a.numpy(), anchors.numpy(), atol=1e-5)
        np.testing.assert_allclose(f.detach().numpy(), feat.detach().numpy(),
                                   atol=1e-5)


def _one_rank_sharded_step(det, args, cfg):
    """The one-rank counterpart of the sharded train step: the same
    forward (train mode, momentum 0.1) and losses, backward; the
    gradients and metrics."""
    src_pc, src_sn, src_node, dst_pc, dst_sn, dst_node, R, sc, sh = args
    det.train()
    _, kp, sig = det(torch.cat([src_pc, dst_pc]), torch.cat([src_sn, dst_sn]),
                     torch.cat([src_node, dst_node]), bn_momentum=0.1)
    b = src_pc.shape[0]
    ch = losses.chamfer_probabilistic(apply_se3(kp[:b], R, sc, sh), kp[b:],
                                      sig[:b], sig[b:])
    on = (losses.single_side_chamfer(kp[:b], src_pc).mean()
          + losses.single_side_chamfer(kp[b:], dst_pc).mean()) \
        * cfg.loss.keypoint_on_pc_alpha
    (ch.loss + on).backward()
    return float((ch.loss + on).detach())


def test_sharded_detector_train_step_matches(ranks):
    """One point-sharded train step: the loss rel 1e-5 of usip_tpu's
    sharded step on make_point_mesh(2) and of the one-rank step; the
    gradients within 1e-5 x max|g| of the one-rank ones; the BatchNorm
    running statistics within 2e-5 of usip_tpu's and the one-rank ones;
    both ranks identical."""
    p, ref, two, _, _ = ranks
    jcfg, jdet, v, _ = ref["detector"]
    args = ref["train"]
    jstate = JaxTrainState.create(v, jax_make_adam(1e-3))
    jnew, jm = jax.jit(jax_sharded_det_step(jcfg, jso.make_point_mesh(
        RANKS)))(jstate, *(jnp.asarray(a) for a in args), jnp.asarray(0))
    cfg = get_config("modelnet", **DET)
    det = Detector(cfg.detector)
    det.load_state_dict(p["detector"]["state_dict"])
    loss = _one_rank_sharded_step(det, p["train"]["args"], cfg)
    jstats = state_dict_from_jax(_host(jnew.variables))
    gmax = max(float(q.grad.abs().max()) for q in det.parameters())
    for res in two:
        tr = res["train"]
        np.testing.assert_allclose(tr["metrics"]["loss"], float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(tr["metrics"]["loss"], loss, rtol=1e-5)
        for n, q in det.named_parameters():
            assert float((tr["grads"][n] - q.grad).abs().max()) \
                <= 1e-5 * gmax, n
        for n, t in det.state_dict().items():
            if n.endswith(("running_mean", "running_var")):
                for r in (t, jstats[n]):
                    np.testing.assert_allclose(tr["state"][n].numpy(),
                                               r.numpy(), rtol=2e-5,
                                               atol=2e-5, err_msg=n)
    assert two[0]["train"]["hash"] == two[1]["train"]["hash"]


def test_sharded_train_2d_grid(ranks):
    """``data x points`` (2 x 2 ranks): three steps finite and the loss
    falling (usip_tpu's test), the first step's loss rel 1e-5 of the
    one-rank step on the whole batch, the four replicas identical."""
    _, _, _, four, grid = ranks
    t = grid["train"]
    cfg = get_config("modelnet", **t["overrides"])
    det = Detector(cfg.detector)
    det.load_state_dict(t["state_dict"])
    loss = _one_rank_sharded_step(det, t["args"], cfg)
    for res in four:
        ls = res["sp_losses"]
        assert np.isfinite(ls).all() and ls[-1] < ls[0]
        np.testing.assert_allclose(ls[0], loss, rtol=1e-5)
    assert len({r["sp_hash"] for r in four}) == 1


def test_sharded_trunk_rejects_unsupported_configs():
    """usip_tpu's refusals: the sharded trunk is som/k=1 only."""
    from usip_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(device="cpu")
    base = {"data.input_pc_num": 64, "data.node_num": 8, "detector.c1": 8,
            "detector.c2": 16, "detector.node_knn_k": 2}
    pc = torch.zeros(2, 64, 3)
    for over, match in (({"detector.grouping": "knn"}, "som"),
                        ({"detector.k": 3}, "k=1")):
        cfg = get_config("modelnet", **base, **over)
        with pytest.raises(NotImplementedError, match=match):
            sharded_trunk_apply(mesh, cfg, None, pc, pc, pc[:, :8], False)
    with pytest.raises(NotImplementedError, match="scan-triplet"):
        make_sharded_descriptor_train_step(get_config("modelnet"), mesh,
                                           use_cgf=True)


# ------------------------------------------------------ sharded descriptor --

@pytest.mark.parametrize("name", ["fp32", "global_bf16"])
def test_sharded_describe_matches(ranks, name):
    """``sharded_describe`` with usip_tpu's priorities: ball features
    within 1e-6 and descriptors within 1e-5 of usip_tpu's sharded
    describe on make_point_mesh(2) (its tests' bounds), in fp32 and for
    the global-context head under bf16."""
    p, ref, two, _, _ = ranks
    q = p["describe"][name]
    jc, jdesc, dv, key = ref["describe_" + name]
    jmesh = jso.make_point_mesh(RANKS)
    jd, jf = jax.jit(lambda *a: jax_sharded_describe(jmesh, jc, *a))(
        dv, *(jnp.asarray(q[k].numpy()) for k in ("pc", "sn", "kp")), key)
    for res in two:
        d, f = res["describe_" + name]
        np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=1e-6)
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-5)


def test_sharded_descriptor_train_step_matches(ranks):
    """The point-sharded descriptor step against usip_tpu's on
    make_point_mesh(2): the loss rel 1e-5, grad_norm rel 1e-4 (its
    gradients are held within 1e-4 x max|g|), the running statistics
    within 2e-5; both ranks' gradients equal (replicated ball
    features)."""
    p, ref, two, _, _ = ranks
    jc, jdet, dets, jdesc, dvs, dargs, key = ref["desc_train"]
    dstate = JaxTrainState.create(dvs, jax_make_adam(1e-3))
    det_state = JaxTrainState.create(dets, jax_make_adam(1e-3))
    jnew, jm = jax.jit(jax_sharded_desc_step(jc, jso.make_point_mesh(
        RANKS)))(dstate, det_state, *(jnp.asarray(a) for a in dargs), key,
                 jnp.asarray(0))
    jstats = state_dict_from_jax(_host(jnew.variables))
    for res in two:
        m = res["desc_train"]["metrics"]
        np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"], float(jm["grad_norm"]),
                                   rtol=1e-4)
        for n, t in res["desc_train"]["state"].items():
            if n.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(t.numpy(), jstats[n].numpy(),
                                           rtol=2e-5, atol=2e-5, err_msg=n)
    for n, g in two[0]["desc_train"]["grads"].items():
        assert torch.equal(g, two[1]["desc_train"]["grads"][n]), n


# ------------------------------------------------------ tensor parallel --

def test_tp_forward_matches(ranks):
    """The TP eval forward on 2 ranks: fp32 within 1e-5 of usip_tpu's TP
    forward on make_channel_mesh(2) and of the one-rank forward; the
    prepared (cut once) params give the same bits; bf16 within 0.05 of
    usip_tpu's one-device forward (its ``test_tp_forward_bf16_close``)."""
    _, ref, two, _, _ = ranks
    cmesh = jtp.make_channel_mesh(RANKS)
    jc, jd, v, det, inputs = ref["tp_fp32"]
    j = jax.jit(lambda *a: jtp.tensor_parallel_detector_forward(
        cmesh, jc, *a))(v, *map(jnp.asarray, inputs))
    one = det.eval()(*map(_t, inputs))
    for res in two:
        for got, rj, r1, prep in zip(res["tp"]["fp32"], j, one,
                                     res["tp"]["prepared"]):
            np.testing.assert_allclose(got.numpy(), np.asarray(rj),
                                       atol=1e-5)
            np.testing.assert_allclose(got.numpy(), r1.detach().numpy(),
                                       atol=1e-5)
            assert torch.equal(got, prep)
    jc, jd, v, det, inputs = ref["tp_bf16"]
    _, kp, sig = jd.apply(v, *map(jnp.asarray, inputs), train=False)
    for res in two:
        _, gkp, gsig = res["tp"]["bf16"]
        np.testing.assert_allclose(gkp.numpy(), np.asarray(kp), atol=0.05)
        np.testing.assert_allclose(gsig.numpy(), np.asarray(sig), atol=0.05)


def test_tp_param_stacks_shard_evenly(ranks):
    """``shard_tp_params``' stacks are usip_tpu's, bit for bit, from the
    same variables (through ``weights.tp_params_from_jax``); every stack
    leads with the shard count; column and row blocks tile the kernels;
    a rank's blocks are its slice of the stacks."""
    _, ref, _, _, _ = ranks
    jc, _, v, det, _ = ref["tp_fp32"]
    cfg = get_config("modelnet", **DET)
    jtp_, jrp = jtp.shard_tp_params(jc, v, 8)
    tp, rp = tp_params_from_jax(cfg, _host(v), 8)
    assert set(tp) == set(jtp_) and set(rp) == set(jrp)
    for k in jtp_:
        assert tp[k].shape[0] == 8
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jtp_[k]),
                                      err_msg=k)
    for k in jrp:
        np.testing.assert_array_equal(rp[k].numpy(), np.asarray(jrp[k]))
    mine, _ = tpm.shard_tp_params(cfg, det, 8, rank=3)
    for k in tp:
        assert torch.equal(mine[k], tp[k][3])


def test_tp_rejects_indivisible_widths(ranks):
    _, ref, _, _, _ = ranks
    det = ref["tp_fp32"][3]
    with pytest.raises(AssertionError, match="not divisible"):
        tpm.shard_tp_params(get_config("modelnet", **DET), det, 3)


def _tp_grads_against_full(res, det, mesh_size, rank):
    """Each TP parameter's gradient against its cut of the one-rank
    gradient (1e-5 x max|g|): a copy of the model holding the gradients
    as its parameters, cut as the parameters are."""
    gmax = max(float(q.grad.abs().max()) for q in det.parameters())
    gdet = copy.deepcopy(det)
    with torch.no_grad():
        for q, g in zip(gdet.parameters(), det.parameters()):
            q.copy_(g.grad)
    cut = tpm.shard_tp_params(det.cfg, gdet, mesh_size, rank)
    full = {n: q.detach() for n, q in gdet.named_parameters()}
    for n, g in res["grads"].items():
        ref = full[n] if n.startswith(("first_pointnet", "second_pointnet")) \
            else _tp_ref(n, cut)
        assert float((g - ref).abs().max()) <= 1e-5 * gmax, n


def _tp_ref(name, cut):
    tp, rp = cut
    parts = name.split(".")                    # tp.<layer>.<what>[...]
    layer, what = parts[1], parts[2:]
    if what == ["w"]:
        return tp[layer + "_w"]
    if what[0] == "w":                         # row blocks: tp.<l>.w.<part>
        return tp[f"{layer}_w{'' if what[1] == 'w' else what[1]}"]
    src = tp if f"{layer}_b" in tp else rp
    key = {("b",): "b", ("norm", "weight"): "s", ("norm", "bias"): "sb"}
    return src[f"{layer}_{key[tuple(what)]}"]


def test_tp_train_step_matches(ranks):
    """``make_tp_train_step`` over ``shard_state_tp`` at 2 ranks: the
    metrics rel 1e-5 of the one-rank step (same draws, usip_tpu's); every
    parameter's gradient within 1e-5 x max|g| of its cut of the one-rank
    gradient; each rank holds about half of the cut layers' parameters;
    the layout (``tp_state_sharding``) names the cut dimensions."""
    p, _, two, four, _ = ranks
    t = p["tp"]["train"]
    cfg = get_config("kitti", **t["overrides"])
    det = Detector(cfg.detector)
    det.load_state_dict(t["state_dict"])
    m = steps.make_detector_train_step(cfg)(
        TrainState.create(det, cfg.train.lr),
        steps.ParentBatch(t["pc"], t["sn"]), t["epoch"], draws=t["draws"])
    for r, res in enumerate(two):
        tr = res["tp"]["train"]
        for k, v in m.items():
            np.testing.assert_allclose(tr["metrics"][k], float(v),
                                       rtol=1e-5, err_msg=k)
        _tp_grads_against_full(tr, det, RANKS, r)
        lay = tr["layout"]
        assert lay["knnlayer_1.layers_before.0.conv.weight"] == 0
        assert lay["knnlayer_1.layers_before.1.conv.weight"] == 1
        assert lay["knnlayer_1.layers_before.1.norm.weight"] is None
        assert lay["mlp3.conv.weight"] is None
        assert lay["first_pointnet.layers.0.conv.weight"] is None
    full = sum(q.numel() for n, q in det.named_parameters()
               if n.startswith(("knnlayer", "mlp")))
    held = sum(v for n, v in two[0]["tp"]["train"]["params"].items()
               if n.startswith("tp."))
    assert held < 0.6 * full
    # data x channels (2 x 2): the same step's metrics
    for res in four:
        for k, v in m.items():
            np.testing.assert_allclose(res["tp"]["metrics"][k], float(v),
                                       rtol=1e-5, err_msg=k)


# ------------------------------------------------------------ pipeline --

def test_pipeline_matches_sequential_and_usip_tpu():
    """detect -> describe over two stages (the CPU twice here; two streams
    on a card) equals the one-stream sequential path bit for bit, and
    usip_tpu's pipeline with the same ball priorities within the fused
    chain's bf16 (2e-2; the keypoints feed the balls, so a small keypoint
    difference moves a descriptor only where a point crosses a ball's
    rim, which these inputs avoid at that bound)."""
    ov = {"data.input_pc_num": 128, "data.node_num": 16, "detector.c1": 16,
          "detector.c2": 32, "detector.node_knn_k": 4,
          "detector.compute_dtype": "float32",
          "descriptor.descriptor_len": 16, "descriptor.ball_nsamples": 8,
          "descriptor.ball_radius": 1.5, "descriptor.surface_normal_len": 3,
          "descriptor.compute_dtype": "float32",
          "descriptor.ball_method": "exact",
          "descriptor.ball_compute_dtype": "float32"}
    jc = jax_get_config("modelnet", **ov)
    cfg = get_config("modelnet", **ov)
    rng = np.random.default_rng(11)
    s = jc.detector.surface_normal_len
    pc, sn, node = _mk(rng, 2, 128, 3), _mk(rng, 2, 128, s), _mk(rng, 2, 16, 3)
    jdet, jdesc = JaxDetector(jc.detector), JaxDescriptor(jc.descriptor)
    dv = jdet.init(jax.random.PRNGKey(0), pc, sn, node, train=False)
    _, kp0, _ = jdet.apply(dv, pc, sn, node, train=False)
    sv = jdesc.init(jax.random.PRNGKey(1), pc, sn, kp0,
                    key=jax.random.PRNGKey(2), train=False)
    batches = [(pc, sn, node), (pc + 0.1, sn, node)]
    key = jax.random.PRNGKey(7)
    devices = jax.devices()
    jout = jax_pipeline(jc, dv, sv, batches, key,
                        devices=(devices[0], devices[1]))
    pri = [_t(jax.random.uniform(k, (2, 128)))
           for k in jax.random.split(key, 2)]
    det, desc = Detector(cfg.detector), Descriptor(cfg.descriptor)
    det.load_state_dict(state_dict_from_jax(_host(dv)), strict=True)
    desc.load_state_dict(state_dict_from_jax(_host(sv)), strict=True)
    mbs = [tuple(map(_t, b)) for b in batches]
    out = pp.pipeline_detect_describe(cfg, det, desc, mbs, pri,
                                      devices=("cpu", "cpu"))
    seq = pp.sequential_detect_describe(cfg, det, desc, mbs, pri)
    assert len(out) == 2
    for got, ref, j in zip(out, seq, jout):
        for a, b, c in zip(got, ref, j):
            assert torch.equal(a, b)
            np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=2e-2)
