"""The port's descriptor training (its train step, the engine, best-checkpoint
selection and a small learning gate) against usip_tpu's, on the CPU at a
small width.

Both packages start from the same numbers: seeded detector and descriptor
weights in the reference layout go into the JAX models and reach the port
through ``state_dict_from_jax``. Inputs come from numpy seeds, and the port
is handed JAX's own draws (``_jax_draws`` repeats usip_tpu's key splits).
usip_tpu's gradients are read from its Adam state after the step: optax's
first moment after one step is ``0.1 g``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from usip_tpu.config import get_config as jax_get_config
from usip_tpu.data import augment as jaug
from usip_tpu.models import Descriptor as JaxDescriptor
from usip_tpu.models import Detector as JaxDetector
from usip_tpu.train import steps as jsteps
from usip_tpu.train.state import TrainState as JaxTrainState
from usip_tpu.train.state import make_adam as jax_make_adam
from usip_tpu.train.torch_import import (convert_descriptor_state_dict,
                                         convert_detector_state_dict)
from usip_tpu_torch import losses
from usip_tpu_torch.config import get_config
from usip_tpu_torch.data import augment
from usip_tpu_torch.models import Descriptor, Detector
from usip_tpu_torch.train import (DescriptorBatch, DescriptorDraws,
                                  TrainState, make_descriptor_train_step,
                                  pack_pair_batch)
from usip_tpu_torch.train import steps
from usip_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from usip_tpu_torch.train.descriptor_loop import DescriptorEngine
from usip_tpu_torch.train.loop import init_detector_state
from usip_tpu_torch.weights import (seeded_descriptor_state_dict,
                                    seeded_state_dict, state_dict_from_jax)

torch.set_num_threads(1)

B, N, M, S = 2, 512, 32, 4
# the KITTI descriptor preset at a small width, fp32, exact selection, the
# height scale on (a train-time augmentation of oxford's), and sigma_max
# above the seeded detector's sigmas (2-6), so that every keypoint weighs
OVERRIDES = {"data.input_pc_num": N, "data.node_num": M,
             "data.fps_subsample_ratio": 2, "detector.c1": 32,
             "detector.c2": 64, "detector.node_knn_k": 4,
             "detector.compute_dtype": "float32",
             "descriptor.descriptor_len": 32,
             "descriptor.ball_nsamples": 16, "descriptor.ball_radius": 2.0,
             "descriptor.compute_dtype": "float32",
             "descriptor.ball_method": "exact",
             "descriptor.ball_compute_dtype": "float32",
             "augment.height_scale": True, "loss.sigma_max": 8.0}
CGF = {**OVERRIDES, "augment.height_scale": False, "loss.cgf_radius": 2.5}


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


def _node_draws(key, cfg):
    """usip_tpu.ops.sampling.sample_nodes' draws."""
    sub = max(cfg.data.node_num, N // cfg.data.fps_subsample_ratio)
    k1, k2 = jax.random.split(key)
    subset = np.stack([np.asarray(jax.random.choice(kb, N, shape=(sub,),
                                                    replace=False))
                       for kb in jax.random.split(k1, B)])
    first = np.asarray(jax.random.randint(k2, (B,), 0, sub))
    return steps.NodeDraws(_t(subset), _t(first))


def _jax_draws(key, cfg, use_cgf, eval_only=False):
    """Every draw of usip_tpu's descriptor step for a batch of B pairs."""
    (k_node_a, k_node_p, k_se3, k_ball_a, k_ball_p, _, k_cgf,
     k_height) = jax.random.split(key, 8)
    aug, m = cfg.augment, cfg.data.node_num
    se3 = cgf = height = None
    if use_cgf:
        k_ang, k_scale, k_shift = jax.random.split(k_se3, 3)
        se3 = augment.SE3Draws(
            _t(jaug._sample_angles(k_ang, aug.rot_type, aug.rot_perturbation,
                                   B)),
            _t(jax.random.uniform(k_scale, (B,), minval=1 - aug.gt_scale_thre,
                                  maxval=1 + aug.gt_scale_thre)),
            _t(jax.random.uniform(k_shift, (B, 3), minval=-aug.gt_shift_thre,
                                  maxval=aug.gt_shift_thre)))
        k1, k2, k3 = jax.random.split(k_cgf, 3)
        cgf = losses.CGFDraws(_t(jax.random.uniform(k1, (B, m, m))),
                              _t(jax.random.uniform(k2, (B, m, m))),
                              _t(jax.random.uniform(k3, (B, m))))
    if aug.height_scale and not eval_only:
        height = _t(jax.random.uniform(k_height, (B,),
                                       minval=aug.height_scale_low,
                                       maxval=aug.height_scale_high))
    return DescriptorDraws(
        nodes_anc=_node_draws(k_node_a, cfg),
        nodes_pos=_node_draws(k_node_p, cfg), se3=se3, height=height,
        ball_anc=_t(jax.random.uniform(k_ball_a, (B, N))),
        ball_pos=_t(jax.random.uniform(k_ball_p, (B, N))), cgf=cgf)


def _setup(overrides, seed=0):
    """Both packages' configs, a pair batch (the positive a noisy
    resampling of the anchor's cloud), the JAX models with their variables,
    and the port's detector and descriptor holding the same numbers."""
    jcfg = jax_get_config("kitti", role="descriptor", **overrides)
    cfg = get_config("kitti", role="descriptor", **overrides)
    rng = np.random.default_rng(seed)
    anc = rng.normal(0, 3, (B, N, 3)).astype(np.float32)
    pos = anc[:, rng.permutation(N)] + rng.normal(
        0, 0.05, (B, N, 3)).astype(np.float32)
    anc_sn, pos_sn = (rng.normal(size=(B, N, S)).astype(np.float32)
                      for _ in range(2))
    batch = (anc, anc_sn, pos, pos_sn, np.array([1, 0]))
    jdet, jdesc = JaxDetector(jcfg.detector), JaxDescriptor(jcfg.descriptor)
    det_vars = convert_detector_state_dict(
        seeded_state_dict(cfg.detector, seed),
        jdet.init(jax.random.PRNGKey(0), _j(anc[:1]), _j(anc_sn[:1]),
                  _j(anc[:1, :M]), train=False))
    desc_vars = convert_descriptor_state_dict(
        seeded_descriptor_state_dict(cfg.descriptor, seed + 1),
        jdesc.init(jax.random.PRNGKey(0), _j(anc[:1]), _j(anc_sn[:1]),
                   _j(anc[:1, :M]), key=jax.random.PRNGKey(1), train=False))
    host = lambda v: jax.tree_util.tree_map(np.asarray, v)  # noqa: E731
    det = Detector(cfg.detector)
    det.load_state_dict(state_dict_from_jax(host(det_vars)), strict=True)
    desc = Descriptor(cfg.descriptor)
    desc.load_state_dict(state_dict_from_jax(host(desc_vars)), strict=True)
    return jcfg, cfg, batch, (jdet, det_vars), (jdesc, desc_vars), det, desc


def _run_both(overrides, use_cgf, eval_only, key, epoch=3):
    jcfg, cfg, batch, (jdet, det_vars), (jdesc, desc_vars), det, desc = \
        _setup(overrides)
    jstate = JaxTrainState.create(desc_vars, jax_make_adam(jcfg.train.lr))
    det_state = JaxTrainState.create(det_vars, jax_make_adam(1e-3))
    jstep = jax.jit(jsteps.make_descriptor_train_step(
        jcfg, jdet, jdesc, use_cgf=use_cgf, eval_only=eval_only))
    jbatch = jsteps.DescriptorBatch(*(_j(x) for x in batch))
    new_state, jm = jstep(jstate, det_state, jbatch, key, jnp.asarray(epoch))
    state = TrainState.create(desc, cfg.train.lr)
    before = {k: v.clone() for k, v in desc.state_dict().items()}
    metrics = make_descriptor_train_step(cfg, use_cgf, eval_only)(
        state, det, DescriptorBatch(*(_t(x) for x in batch)), epoch,
        draws=_jax_draws(key, cfg, use_cgf, eval_only))
    assert set(metrics) == set(jm)
    for k in jm:
        # grad_norm sums the gradients, which are held within 1e-4 x max|g|
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                   rtol=1e-4 if k == "grad_norm" else 1e-5,
                                   atol=1e-6, err_msg=k)
    assert float(metrics["loss"]) > 0
    return new_state, jstate, state, desc, before


def _check_trained(new_state, jstate, desc, before):
    """Gradients within 1e-4 x max|g| (usip_tpu's from its Adam moment);
    the parameters after Adam within 1e-5 where the gradient is well above
    rounding noise; the running statistics after the two sequential updates
    within 2e-5 relative: fp32 cancellation in ``E[x^2] - E[x]^2`` over
    conv1's outputs, whose means are large beside their spread, where the
    two packages' reductions sum in different orders."""
    mu = new_state.opt_state.inner_state[0].mu
    ref_g = state_dict_from_jax({
        "params": jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1, mu),
        "batch_stats": new_state.batch_stats})
    gmax = max(float(ref_g[n].abs().max()) for n, _ in desc.named_parameters())
    assert gmax > 0
    for name, p in desc.named_parameters():
        err = float((p.grad - ref_g[name]).abs().max())
        assert err <= 1e-4 * gmax, (name, err, gmax)
    after = state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, new_state.variables))
    stats = state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, jstate.variables))
    for name, t in desc.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), after[name].numpy(),
                                       rtol=2e-5, atol=1e-6, err_msg=name)
            assert not torch.equal(after[name], stats[name]), name
            continue
        sure = (ref_g[name].abs() > 1e-3 * gmax).numpy()
        np.testing.assert_allclose(t.numpy()[sure], after[name].numpy()[sure],
                                   rtol=0, atol=1e-5, err_msg=name)
        assert not torch.equal(t, before[name]) or not sure.any(), name


def test_scan_step_matches_jax():
    """One scan-triplet step (frozen detector on both clouds, the height
    scale after detection, the descriptor twice in train mode, anchor then
    positive, the in-batch negatives, backward, Adam) against usip_tpu's
    make_descriptor_train_step with the same draws: the loss and every
    metric rel 1e-5 (grad_norm 1e-4, as the gradients), and
    ``_check_trained``'s gradients, parameters and running statistics."""
    new_state, jstate, state, desc, before = _run_both(
        OVERRIDES, False, False, jax.random.PRNGKey(21))
    assert state.step == 1
    _check_trained(new_state, jstate, desc, before)


def test_cgf_step_matches_jax():
    """One CGF step (the GT transform of the positive, the anchor's
    keypoints aligned into its frame, the CGF triplet with JAX's uniforms,
    ``match_acc``) against usip_tpu's, as ``test_scan_step_matches_jax``."""
    new_state, jstate, state, desc, before = _run_both(
        CGF, True, False, jax.random.PRNGKey(22))
    assert state.step == 1
    _check_trained(new_state, jstate, desc, before)


@pytest.mark.parametrize("use_cgf", [False, True])
def test_eval_only_step_matches_jax(use_cgf):
    """``eval_only``: the running statistics, no height scale, no step;
    the metrics rel 1e-5 and the state untouched."""
    _, _, state, desc, before = _run_both(
        CGF if use_cgf else OVERRIDES, use_cgf, True, jax.random.PRNGKey(23))
    assert state.step == 0
    for k, v in desc.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(p.grad is None for p in desc.parameters())


def test_descriptor_steps_from_a_generator():
    """Without injected draws every step draws from its generator: the
    packed wire in fp16, finite metrics, parameters and statistics that
    move, and the same seed repeats a step; CGF with the height scale is
    refused."""
    _, cfg, batch, _, _, det, desc = _setup(OVERRIDES)
    start = {k: v.clone() for k, v in desc.state_dict().items()}
    packed = pack_pair_batch(*batch)
    assert packed.x.dtype == np.float16 and packed.x.shape == (B, 2, N, 3 + S)
    wire = steps.PackedPairBatch(_t(packed.x), _t(packed.neg_idx))
    step = make_descriptor_train_step(cfg)
    losses_ = []
    for seed in (0, 0):
        desc.load_state_dict(start)
        state = TrainState.create(desc, cfg.train.lr)
        g = torch.Generator().manual_seed(seed)
        m = [step(state, det, wire, e, generator=g) for e in range(2)]
        assert all(bool(torch.isfinite(v)) for x in m for v in x.values())
        losses_.append(m[0]["loss"])
    assert torch.equal(*losses_) and state.step == 2
    moved = [k for k, v in desc.state_dict().items()
             if not torch.equal(v, start[k])]
    assert any(k.endswith("running_var") for k in moved)
    assert any(k.endswith("conv.weight") for k in moved)
    with pytest.raises(NotImplementedError, match="height_scale"):
        make_descriptor_train_step(cfg, use_cgf=True)


@pytest.mark.parametrize("use_cgf,eval_only", [(False, False),
                                               (True, False), (False, True)])
def test_descriptor_step_marks_its_parts(use_cgf, eval_only):
    """``mark`` is called once after each of the step's parts (node
    sampling, frozen detector, ball queries, trunk, losses, then backward
    and optimizer when it steps) and changes nothing: from the same start
    and generator seed the step gives the same metrics and state with and
    without it."""
    _, cfg, batch, _, _, det, desc = _setup(CGF if use_cgf else OVERRIDES)
    start = {k: v.clone() for k, v in desc.state_dict().items()}
    wire = steps.PackedPairBatch(*(_t(x) for x in pack_pair_batch(*batch)))
    step = make_descriptor_train_step(cfg, use_cgf, eval_only)
    calls, runs = [], []
    for mark in (None, lambda: calls.append(len(calls))):
        desc.load_state_dict(start)
        state = TrainState.create(desc, cfg.train.lr)
        metrics = step(state, det, wire, 1, mark=mark,
                       generator=torch.Generator().manual_seed(0))
        runs.append((metrics, {k: v.clone()
                               for k, v in desc.state_dict().items()}))
    assert calls == list(range(5 if eval_only else 7))
    (m0, w0), (m1, w1) = runs
    assert m0.keys() == m1.keys()
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(w0[k], w1[k]) for k in w0)


# --------------------------------------------------------------- engine ----

TINY = {"data.input_pc_num": 128, "data.node_num": 16,
        "detector.c1": 16, "detector.c2": 32, "detector.node_knn_k": 4,
        "descriptor.descriptor_len": 16, "descriptor.ball_nsamples": 8,
        "descriptor.ball_radius": 0.75, "descriptor.surface_normal_len": 4,
        "train.batch_size": 2, "train.log_every": 1000}


def _detector_checkpoint(cfg, path):
    save_checkpoint(path, init_detector_state(cfg, 0))
    return path


def _engine(cfg, tmp_path, name, **kw):
    ckpt = _detector_checkpoint(cfg, str(tmp_path / "det.pt"))
    return DescriptorEngine(cfg, ckpt, synthetic=True, device="cpu",
                            out_dir=str(tmp_path / name), **kw)


def test_descriptor_engine_fits_and_resumes(tmp_path):
    """Two epochs of the scan objective on the synthetic pairs (kitti
    preset, bf16 balls and trunk), then a new engine resumes from
    ``last.pt`` at epoch 2 and trains a third; the checkpoints, the
    metrics log, the restored step and the abort after non-finite losses."""
    cfg = get_config("kitti", role="descriptor",
                     **{**TINY, "data.parent_pc_num": 160,
                        "train.keep_epoch_checkpoints": True})
    eng = _engine(cfg, tmp_path, "desc")
    assert not eng.use_cgf
    eng.fit(2)
    files = set(os.listdir(eng.out_dir))
    assert {"best.pt", "last.pt", "last.pt.json", "epoch_0.pt",
            "epoch_1.pt", "train_desc_metrics.jsonl"} <= files
    steps_two = eng.state.step
    assert steps_two == 2 * len(eng.train_loader)
    again = _engine(cfg, tmp_path, "desc")
    assert again.resume(os.path.join(eng.out_dir, "last.pt")) == 2
    assert again.state.step == steps_two
    for k, v in eng.state.model.state_dict().items():
        assert torch.equal(again.state.model.state_dict()[k], v), k
    again.fit(3)
    assert again.state.step == 3 * len(eng.train_loader)
    assert all(p.grad is None or not p.requires_grad
               for p in again.detector.parameters())
    again.cfg = again.cfg.with_overrides(**{"train.log_every": 1})
    again.step_fn = lambda *a, **k: {"loss": torch.tensor(float("nan"))}
    with pytest.raises(FloatingPointError, match="non-finite"):
        again.train_epoch(3)


def test_match_acc_selection_and_guards(tmp_path):
    """``select_best_by='match_acc'`` (the CGF objective emits match_acc and
    gates best.pt on it, not on the loss; resume restores the criterion's
    score), and the refusals: match_acc without the CGF objective, an
    unknown criterion, more than one device (mirrors usip_tpu's
    tests/test_descriptor_selection.py)."""
    cfg = get_config("scenenn", role="descriptor",
                     **{**TINY, "train.select_best_by": "match_acc"})
    assert cfg.descriptor.use_global_context
    eng = _engine(cfg, tmp_path, "desc")
    assert eng.use_cgf
    avg = eng.train_epoch(0)
    assert 0.0 <= avg["match_acc"] <= 1.0
    assert eng.maybe_save(0, {"loss": 0.5, "match_acc": 0.2})
    assert not eng.maybe_save(1, {"loss": 0.1, "match_acc": 0.1})
    assert eng.maybe_save(2, {"loss": 0.9, "match_acc": 0.3})
    best = os.path.join(eng.out_dir, "best.pt")
    assert restore_checkpoint(best, eng.state)["epoch"] == 2
    again = _engine(cfg, tmp_path, "desc2")
    again.resume(best)
    assert again.best_test_loss == pytest.approx(-0.3)
    assert not again.maybe_save(3, {"loss": 0.0, "match_acc": 0.25})

    outdoor = get_config("kitti", role="descriptor",
                         **{**TINY, "data.parent_pc_num": 160,
                            "train.select_best_by": "match_acc"})
    with pytest.raises(ValueError, match="match_acc"):
        _engine(outdoor, tmp_path, "bad1")
    bad = get_config("scenenn", role="descriptor",
                     **{**TINY, "train.select_best_by": "recall"})
    with pytest.raises(ValueError, match="select_best_by"):
        _engine(bad, tmp_path, "bad2")
    # two ranks asked for, one process: refused, never run as one rank
    multi = cfg.with_overrides(**{"train.num_devices": 2})
    with pytest.raises(ValueError, match="has 1 ranks"):
        _engine(multi, tmp_path, "bad3")


def test_descriptor_learns_yaw_matching(tmp_path):
    """The descriptor learning gate at usip_tpu's test size
    (tests/test_descriptor_learning.py: modelnet, 256 points, 32 nodes, 128
    shapes, 8 detector and 30 descriptor epochs, the CGF objective under
    yaw, a yaw-rotated partner at test): trained 1-NN matching accuracy at
    least 1.3x the untrained descriptor's, and above 0.10."""
    from usip_tpu_torch.quality import LEARNING_TEST, run_descriptor
    res = run_descriptor(str(tmp_path), device="cpu", **LEARNING_TEST)
    print(f"\n[descriptor-gate] {res}")
    assert res["trained"] >= 1.3 * res["untrained"], res
    assert res["trained"] > 0.10, res
