"""The indoor descriptor (the scenenn descriptor preset: the lite detector,
the global-context descriptor, the CGF objective) against usip_tpu's, on
the CPU at a small width: a few hundred points, 32 keypoints, balls of 96
(more than any earlier test's 64; the train step's gradients at 16),
fp32.

Seeded weights in the reference layout go into the JAX models and reach the
port through ``state_dict_from_jax``; the port is handed JAX's own draws
(priorities, node draws, the GT transform, the CGF uniforms). usip_tpu's
gradients are read from its Adam state after the step (optax's first
moment after one step is ``0.1 g``).
"""

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
                                         convert_detector_state_dict,
                                         export_descriptor_state_dict)
from usip_tpu_torch import losses
from usip_tpu_torch.config import get_config
from usip_tpu_torch.data import augment
from usip_tpu_torch.models import Descriptor, Detector
from usip_tpu_torch.train import (DescriptorBatch, DescriptorDraws,
                                  TrainState, make_descriptor_train_step)
from usip_tpu_torch.train import steps
from usip_tpu_torch.train.checkpoint import save_checkpoint
from usip_tpu_torch.train.descriptor_loop import DescriptorEngine
from usip_tpu_torch.train.loop import init_detector_state
from usip_tpu_torch.weights import (seeded_descriptor_state_dict,
                                    seeded_state_dict, state_dict_from_jax)

torch.set_num_threads(1)

B, N, M, K, S = 2, 384, 32, 96, 4
# the scenenn descriptor preset at a small width, fp32: balls of 96 in the
# preset's radius 0.75 over clouds of sigma 0.5 (some balls overflow 96,
# some hold a few points); the CGF radius widened to 0.3 so that the
# anchor's keypoints find positives among 32, and sigma_max above the
# head-initialised detector's sigmas (~0.69), so that every keypoint weighs
SMALL = {"data.input_pc_num": N, "data.node_num": M,
         "data.fps_subsample_ratio": 2, "detector.c1": 32,
         "detector.c2": 64, "detector.compute_dtype": "float32",
         "descriptor.ball_nsamples": K,
         "descriptor.compute_dtype": "float32", "loss.cgf_radius": 0.3,
         "loss.sigma_max": 8.0}


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


def _configs(k=K):
    over = {**SMALL, "descriptor.ball_nsamples": k}
    cfg = get_config("scenenn", role="descriptor", **over)
    jcfg = jax_get_config("scenenn", role="descriptor", **over)
    assert cfg.descriptor.use_global_context and cfg.detector.c1 == 32
    assert cfg.descriptor.ball_radius == 0.75
    assert cfg.descriptor.ball_method == "exact"
    return cfg, jcfg


def _cloud(seed):
    rng = np.random.default_rng(seed)
    pc = rng.normal(0, 0.5, (B, N, 3)).astype(np.float32)
    sn = rng.normal(size=(B, N, S)).astype(np.float32)
    kp = pc[:, :M] + rng.normal(0, 0.1, (B, M, 3)).astype(np.float32)
    kp[:, -1] = 10.0  # an empty ball
    return pc, sn, kp


def test_scenenn_descriptor_forward_matches_jax():
    """The global-context descriptor's eval forward at the scenenn preset
    (balls of 96 in 0.75, fp32, JAX's priorities): ball features (and so
    the ball indices) identical, descriptors within 1e-5."""
    cfg, jcfg = _configs()
    pc, sn, kp = _cloud(0)
    jmodel = JaxDescriptor(jcfg.descriptor)
    init = jmodel.init(jax.random.PRNGKey(0), _j(pc), _j(sn), _j(kp),
                       key=jax.random.PRNGKey(1), train=False)
    variables = convert_descriptor_state_dict(
        seeded_descriptor_state_dict(cfg.descriptor, 3), init)
    model = Descriptor(cfg.descriptor)
    model.load_state_dict({k: _t(v) for k, v in export_descriptor_state_dict(
        jax.tree_util.tree_map(np.asarray, variables)).items()}, strict=True)
    model.eval()
    key = jax.random.PRNGKey(5)
    jdesc, jfeats = jmodel.apply(variables, _j(pc), _j(sn), _j(kp), key=key,
                                 train=False)
    prio = _t(jax.random.uniform(key, (B, N)))
    with torch.no_grad():
        desc, feats = model(_t(pc), _t(sn), _t(kp), prio)
    inside = ((_t(pc)[:, None] - _t(kp)[:, :, None]).square().sum(-1)
              <= 0.75 ** 2).sum(-1)
    assert bool((inside > K).any() and (inside < K).any()
                and (inside == 0).any())
    assert feats.shape == (B, M, K, 3 + S)
    np.testing.assert_array_equal(feats.numpy(), np.asarray(jfeats))
    np.testing.assert_allclose(desc.numpy(), np.asarray(jdesc), rtol=1e-5,
                               atol=1e-5)


def _node_draws(key, cfg):
    """usip_tpu.ops.sampling.sample_nodes' draws."""
    sub = max(cfg.data.node_num, N // cfg.data.fps_subsample_ratio)
    k1, k2 = jax.random.split(key)
    subset = np.stack([np.asarray(jax.random.choice(kb, N, shape=(sub,),
                                                    replace=False))
                       for kb in jax.random.split(k1, B)])
    first = np.asarray(jax.random.randint(k2, (B,), 0, sub))
    return steps.NodeDraws(_t(subset), _t(first))


def _cgf_draws(key, cfg):
    """Every draw of usip_tpu's CGF descriptor step for a batch of B pairs
    (the scenenn preset has no height scale)."""
    (k_node_a, k_node_p, k_se3, k_ball_a, k_ball_p, _, k_cgf,
     _) = jax.random.split(key, 8)
    aug, m = cfg.augment, cfg.data.node_num
    assert not aug.height_scale
    k_ang, k_scale, k_shift = jax.random.split(k_se3, 3)
    se3 = augment.SE3Draws(
        _t(jaug._sample_angles(k_ang, aug.rot_type, aug.rot_perturbation, B)),
        _t(jax.random.uniform(k_scale, (B,), minval=1 - aug.gt_scale_thre,
                              maxval=1 + aug.gt_scale_thre)),
        _t(jax.random.uniform(k_shift, (B, 3), minval=-aug.gt_shift_thre,
                              maxval=aug.gt_shift_thre)))
    k1, k2, k3 = jax.random.split(k_cgf, 3)
    cgf = losses.CGFDraws(_t(jax.random.uniform(k1, (B, m, m))),
                          _t(jax.random.uniform(k2, (B, m, m))),
                          _t(jax.random.uniform(k3, (B, m))))
    return DescriptorDraws(
        nodes_anc=_node_draws(k_node_a, cfg),
        nodes_pos=_node_draws(k_node_p, cfg), se3=se3, height=None,
        ball_anc=_t(jax.random.uniform(k_ball_a, (B, N))),
        ball_pos=_t(jax.random.uniform(k_ball_p, (B, N))), cgf=cgf)


@pytest.mark.parametrize("k,eval_only", [(16, False), (K, True)])
def test_scenenn_cgf_step_matches_jax(k, eval_only):
    """One CGF step at the scenenn preset (the lite detector frozen, the
    global-context descriptor on both clouds, the GT transform, the CGF
    triplet with JAX's uniforms, ``match_acc``) against usip_tpu's
    ``make_descriptor_train_step``: every metric rel 1e-5 (grad_norm 1e-4).
    The train step (balls of 16): every gradient within 1e-4 x max|g|; the
    parameters after Adam within 1e-5 where the gradient is well above
    rounding noise; the running statistics within 2e-5 relative (the
    tolerances of ``tests/test_torch_descriptor_train.py``). At balls of 96
    the eval-only step (the test sweep's): its metrics, no step. The train
    step's fp32 gradients below conv4 are not held at 96: ball maxima
    within rounding of a tie, which the packages order differently, send
    the split-kernel layer's summed gradient to different points (ROADMAP
    Queue C)."""
    cfg, jcfg = _configs(k)
    rng = np.random.default_rng(1)
    anc = rng.normal(0, 0.5, (B, N, 3)).astype(np.float32)
    pos = anc[:, rng.permutation(N)] + rng.normal(
        0, 0.01, (B, N, 3)).astype(np.float32)
    anc_sn, pos_sn = (rng.normal(size=(B, N, S)).astype(np.float32)
                      for _ in range(2))
    batch = (anc, anc_sn, pos, pos_sn, np.array([1, 0]))
    jdet, jdesc = JaxDetector(jcfg.detector), JaxDescriptor(jcfg.descriptor)
    # the keypoint head at the training init's scale (as chip_smoke.py's
    # seeded_detector(head_init=True)): keypoints near the nodes
    det_sd = seeded_state_dict(cfg.detector, 0)
    det_sd["mlp3.conv.weight"] = det_sd["mlp3.conv.weight"] * (1e-4 / 0.05)
    det_sd["mlp3.conv.bias"] = det_sd["mlp3.conv.bias"] * 0.0
    det_vars = convert_detector_state_dict(
        det_sd,
        jdet.init(jax.random.PRNGKey(0), _j(anc[:1]), _j(anc_sn[:1]),
                  _j(anc[:1, :M]), train=False))
    desc_vars = convert_descriptor_state_dict(
        seeded_descriptor_state_dict(cfg.descriptor, 1),
        jdesc.init(jax.random.PRNGKey(0), _j(anc[:1]), _j(anc_sn[:1]),
                   _j(anc[:1, :M]), key=jax.random.PRNGKey(1), train=False))
    host = lambda v: jax.tree_util.tree_map(np.asarray, v)  # noqa: E731
    det = Detector(cfg.detector)
    det.load_state_dict(state_dict_from_jax(host(det_vars)), strict=True)
    desc = Descriptor(cfg.descriptor)
    desc.load_state_dict(state_dict_from_jax(host(desc_vars)), strict=True)

    key, epoch = jax.random.PRNGKey(24), 3
    jstate = JaxTrainState.create(desc_vars, jax_make_adam(jcfg.train.lr))
    jstep = jax.jit(jsteps.make_descriptor_train_step(
        jcfg, jdet, jdesc, use_cgf=True, eval_only=eval_only))
    new_state, jm = jstep(jstate, JaxTrainState.create(
        det_vars, jax_make_adam(1e-3)), jsteps.DescriptorBatch(
            *(_j(x) for x in batch)), key, jnp.asarray(epoch))
    state = TrainState.create(desc, cfg.train.lr)
    before = {name: v.clone() for name, v in desc.state_dict().items()}
    metrics = make_descriptor_train_step(cfg, True, eval_only)(
        state, det, DescriptorBatch(*(_t(x) for x in batch)), epoch,
        draws=_cgf_draws(key, cfg))
    assert set(metrics) == set(jm) and "match_acc" in jm
    for name in jm:
        np.testing.assert_allclose(float(metrics[name]), float(jm[name]),
                                   rtol=1e-4 if name == "grad_norm" else 1e-5,
                                   atol=1e-6, err_msg=name)
    assert float(metrics["loss"]) > 0
    if eval_only:
        assert state.step == 0
        for name, v in desc.state_dict().items():
            assert torch.equal(v, before[name]), name
        return
    assert state.step == 1

    mu = new_state.opt_state.inner_state[0].mu
    ref_g = state_dict_from_jax({
        "params": jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1, mu),
        "batch_stats": new_state.batch_stats})
    gmax = max(float(ref_g[n].abs().max()) for n, _ in desc.named_parameters())
    assert gmax > 0
    for name, p in desc.named_parameters():
        err = float((p.grad - ref_g[name]).abs().max())
        assert err <= 1e-4 * gmax, (name, err, gmax)
    after = state_dict_from_jax(host(new_state.variables))
    for name, t in desc.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), after[name].numpy(),
                                       rtol=2e-5, atol=1e-6, err_msg=name)
            continue
        sure = (ref_g[name].abs() > 1e-3 * gmax).numpy()
        np.testing.assert_allclose(t.numpy()[sure], after[name].numpy()[sure],
                                   rtol=0, atol=1e-5, err_msg=name)
        assert not torch.equal(t, before[name]) or not sure.any(), name


def test_lite_detector_restores_into_the_descriptor_role(tmp_path):
    """A detector checkpoint written under the scenenn detector role (lite
    widths, node kNN 32) restores into the descriptor engine's descriptor
    role (node kNN 4), as usip_tpu's does: the same weights, the role's
    kNN, and the CGF objective with match_acc gating selected."""
    over = {"data.input_pc_num": 256, "data.node_num": 32,
            "data.fps_subsample_ratio": 2, "train.batch_size": 2,
            "descriptor.ball_nsamples": 16}
    det_cfg = get_config("scenenn", **over)
    det_cfg = det_cfg.with_overrides(**{"detector.c1": 64,
                                        "detector.c2": 256})
    assert det_cfg.detector.node_knn_k == 32
    ckpt = str(tmp_path / "det.pt")
    det_state = init_detector_state(det_cfg, 4)
    save_checkpoint(ckpt, det_state)
    cfg = get_config("scenenn", role="descriptor",
                     **{**over, "train.select_best_by": "match_acc"})
    assert (cfg.detector.c1, cfg.detector.c2, cfg.detector.node_knn_k) == \
        (64, 256, 4)
    eng = DescriptorEngine(cfg, ckpt, synthetic=True, device="cpu",
                           out_dir=str(tmp_path / "desc"))
    assert eng.use_cgf and eng.detector.cfg.node_knn_k == 4
    for k, v in det_state.model.state_dict().items():
        assert torch.equal(eng.detector.state_dict()[k], v), k
