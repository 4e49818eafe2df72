"""Port training (usip_tpu_torch.{data.augment, losses, train}) against
usip_tpu's, on the CPU at a small width.

Both sides start from the same numbers: seeded weights in the reference
layout go into the JAX detector, whose variables reach the port through
``state_dict_from_jax``. Inputs come from a numpy seed, and the port is
handed JAX's own random draws (``_jax_draws`` repeats usip_tpu's key splits
and draws), since JAX keys and torch generators never agree. The JAX side
runs on the CPU (its FPS through the XLA loop), the steps jitted.
"""

import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from usip_tpu import losses as jlosses
from usip_tpu.config import get_config as jax_get_config
from usip_tpu.data import augment as jaug
from usip_tpu.models import Detector as JaxDetector
from usip_tpu.nn.layers import BatchNorm as JaxBatchNorm
from usip_tpu.nn.layers import bn_momentum_schedule as jax_bn_schedule
from usip_tpu.ops import masked_scatter_max as jax_scatter_max
from usip_tpu.ops.geometry import nearest_neighbor as jax_nearest
from usip_tpu.train import steps as jsteps
from usip_tpu.train.state import TrainState as JaxTrainState
from usip_tpu.train.state import make_adam as jax_make_adam
from usip_tpu.train.torch_import import convert_detector_state_dict
from usip_tpu_torch import losses
from usip_tpu_torch.config import get_config
from usip_tpu_torch.data import augment
from usip_tpu_torch.models import Detector
from usip_tpu_torch.nn.layers import (BatchNorm, bn_momentum_schedule,
                                      set_bn_momentum)
from usip_tpu_torch.ops import masked_scatter_max
from usip_tpu_torch.ops.geometry import nearest_neighbor
from usip_tpu_torch.train import (TrainState, lr_at_epoch, make_adam,
                                  set_learning_rate)
from usip_tpu_torch.train import steps
from usip_tpu_torch.utils.logging import recording
from usip_tpu_torch.weights import seeded_state_dict, state_dict_from_jax

torch.set_num_threads(1)

B, N, M, S, P = 2, 512, 64, 4, 640
# the KITTI preset at a small width, fp32, with point dropout on (the preset
# has it off) so that the step also meets duplicated points, and FPS over
# half the cloud
OVERRIDES = {"data.input_pc_num": N, "data.node_num": M,
             "data.parent_pc_num": P, "data.fps_subsample_ratio": 2,
             "detector.c1": 32, "detector.c2": 64, "detector.node_knn_k": 4,
             "detector.compute_dtype": "float32",
             "train.random_pc_dropout_lower_limit": 0.5}


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


def _close(port, ref, rtol=1e-5, atol=1e-6, what=""):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol,
                               atol=atol, err_msg=what)


# ------------------------------------------------------------- draws ----

def _jax_node_draws(key, b, n, cfg):
    """usip_tpu.ops.sampling.sample_nodes' draws."""
    sub = max(cfg.data.node_num, n // cfg.data.fps_subsample_ratio)
    k1, k2 = jax.random.split(key)
    subset = np.stack([np.asarray(jax.random.choice(kb, n, shape=(sub,),
                                                    replace=False))
                       for kb in jax.random.split(k1, b)])
    first = np.asarray(jax.random.randint(k2, (b,), 0, sub))
    return steps.NodeDraws(_t(subset), _t(first))


def _jax_se3_draws(key, aug, b):
    k_ang, k_scale, k_shift = jax.random.split(key, 3)
    angles = jaug._sample_angles(k_ang, aug.rot_type, aug.rot_perturbation, b)
    scale = jax.random.uniform(k_scale, (b,), minval=1.0 - aug.gt_scale_thre,
                               maxval=1.0 + aug.gt_scale_thre)
    shift = jax.random.uniform(k_shift, (b, 3), minval=-aug.gt_shift_thre,
                               maxval=aug.gt_shift_thre)
    return augment.SE3Draws(_t(angles), _t(scale), _t(shift))


def _jax_shared_draws(key, aug, shapes):
    """usip_tpu.data.augment.shared_augment's draws; ``shapes`` the packs'
    (pc, sn, node) shapes."""
    b = shapes[0][0][0]
    k_ang, k_scale, k_shift, k_jit = jax.random.split(key, 4)
    angles = jaug._sample_angles(k_ang, aug.rot_type, aug.rot_perturbation, b)
    scale = jax.random.uniform(k_scale, (b,), minval=aug.aug_scale_low,
                               maxval=aug.aug_scale_high)
    shift = jax.random.uniform(k_shift, (b, 3), minval=-0.1, maxval=0.1)
    jitter = None
    if aug.jitter:
        jit_keys = jax.random.split(k_jit, len(shapes))
        jitter = []
        for i, pack in enumerate(shapes):
            jk = jit_keys[0] if aug.shared_jitter else jit_keys[i]
            jitter.append(tuple(_t(jax.random.normal(k, shape)) for k, shape
                                in zip(jax.random.split(jk, 3), pack)))
    return augment.AugmentDraws(_t(angles), _t(scale), _t(shift), jitter)


def _jax_draws(key, cfg, train=True):
    """Every draw of usip_tpu's _prepare_detector_inputs for a batch of B
    parents (the 'slice' siamese mode draws nothing)."""
    k_sub, k_drop, k_height, k_node_s, k_node_d, k_shared, k_se3 = \
        jax.random.split(key, 7)
    del k_sub, k_height
    dropout = None
    if train and cfg.train.random_pc_dropout_lower_limit < 0.99:
        k_ratio, k_perm, k_fill = jax.random.split(k_drop, 3)
        ratio = jax.random.uniform(
            k_ratio, (), minval=cfg.train.random_pc_dropout_lower_limit,
            maxval=1.0)
        keep = jnp.round(ratio * N).astype(jnp.int32)
        perm = jax.random.permutation(k_perm, N)
        fill = jax.random.randint(k_fill, (N,), 0, jnp.maximum(keep, 1))
        dropout = steps.DropoutDraws(_t(ratio), _t(perm), _t(fill))
    shapes = [((B, N, 3), (B, N, S), (B, M, 3))] * 2
    return steps.DetectorDraws(
        dropout=dropout,
        nodes_src=_jax_node_draws(k_node_s, B, N, cfg),
        nodes_dst=_jax_node_draws(k_node_d, B, N, cfg),
        shared=(_jax_shared_draws(k_shared, cfg.augment, shapes) if train
                else None),
        se3=_jax_se3_draws(k_se3, cfg.augment, B))


# --------------------------------------------------------- augment ----

def _cloud(seed, b=B, n=N):
    rng = np.random.default_rng(seed)
    pc = rng.normal(0, 3, (b, n, 3)).astype(np.float32)
    sn = rng.normal(size=(b, n, S)).astype(np.float32)
    return pc, sn


@pytest.mark.parametrize("rot", ["2d", "3d"])
def test_augment_matches_jax(rot):
    """rotation_matrix, random_se3, shared_augment (per-copy jitter, scale,
    shift) and random_height_scale with JAX's draws: rel 1e-5."""
    cfg = jax_get_config("kitti", **{"augment.rot_3d": rot == "3d",
                                     "augment.rot_perturbation": True,
                                     "augment.translation_perturbation": True,
                                     "augment.scale_sn": True})
    aug = cfg.augment
    pc, sn = _cloud(1)
    node = pc[:, :M]
    key = jax.random.PRNGKey(3)
    k_se3, k_shared, k_height = jax.random.split(key, 3)

    ref = jaug.random_se3(k_se3, _j(pc), _j(sn), _j(node),
                          rot_type=aug.rot_type, scale_thre=0.2,
                          shift_thre=aug.gt_shift_thre,
                          rot_perturbation=True)
    d = _jax_se3_draws(k_se3, aug.__class__(**{
        **aug.__dict__, "gt_scale_thre": 0.2}), B)
    out = augment.random_se3(_t(pc), _t(sn), _t(node), rot_type=aug.rot_type,
                             scale_thre=0.2, shift_thre=aug.gt_shift_thre,
                             rot_perturbation=True, draws=d)
    for o, r in zip(out[:3], ref[:3]):
        _close(o, r, atol=1e-5)
    for o, r in zip(out[3], ref[3]):
        _close(o, r)

    packs = [(pc, sn, node), (pc + 1, sn, node + 1)]
    ref = jaug.shared_augment(k_shared, [tuple(map(_j, p)) for p in packs],
                              aug, scale_low=aug.aug_scale_low,
                              scale_high=aug.aug_scale_high)
    d = _jax_shared_draws(k_shared, aug, [tuple(x.shape for x in p)
                                          for p in packs])
    out = augment.shared_augment([tuple(map(_t, p)) for p in packs], aug,
                                 scale_low=aug.aug_scale_low,
                                 scale_high=aug.aug_scale_high, draws=d)
    for op, rp in zip(out, ref):
        for o, r in zip(op, rp):
            _close(o, r, atol=1e-5)

    scale = jax.random.uniform(k_height, (B,), minval=0.25, maxval=1.2)
    ref = jaug.random_height_scale(k_height, [_j(pc), _j(node)], axis=1)
    out = augment.random_height_scale([_t(pc), _t(node)], axis=1,
                                      scale=_t(scale))
    for o, r in zip(out, ref):
        _close(o, r, rtol=0, atol=0)


def test_augment_draws_from_a_generator():
    """Without injected draws each function draws from the generator:
    rotations are orthonormal, scales and shifts within their ranges, the
    normals' extra channels untouched, and one seed repeats its draws."""
    cfg = get_config("kitti")
    pc, sn = _cloud(2)
    outs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(5)
        out = augment.random_se3(_t(pc), _t(sn), _t(pc[:, :M]),
                                 rot_type="2d", scale_thre=0.2,
                                 shift_thre=0.5, generator=g)
        outs.append(out)
        R, scale, shift = out[3]
        eye = torch.eye(3).expand(B, 3, 3)
        assert torch.allclose(R @ R.transpose(1, 2), eye, atol=1e-6)
        assert bool(((scale >= 0.8) & (scale <= 1.2)).all())
        assert bool((shift.abs() <= 0.5).all())
        assert torch.equal(out[1][..., 3:], _t(sn)[..., 3:])
        packs = augment.shared_augment([(_t(pc), _t(sn), _t(pc[:, :M]))] * 2,
                                       cfg.augment, generator=g)
        # per-copy jitter: the two copies differ
        assert not torch.equal(packs[0][0], packs[1][0])
    assert torch.equal(outs[0][0], outs[1][0])


# ----------------------------------------------------------- losses ----

def _grid(rng, shape):
    """Coordinates on a 1/8 grid: every product and sum of the distance
    expansion is exact, so usip_tpu's matmul distances and the port's
    elementwise ones agree bit for bit (and ties resolve alike)."""
    return (rng.integers(-24, 25, shape) / 8.0).astype(np.float32)


def test_nearest_neighbor_matches_jax():
    """Distances, indices and both gradients (a keypoint on a cloud point
    gets no gradient): rel 1e-5."""
    rng = np.random.default_rng(4)
    src, dst = _grid(rng, (B, 96, 3)), _grid(rng, (B, 300, 3))
    src[:, :5] = dst[:, 10:15]          # coincident points: distance 0
    g = rng.normal(size=(B, 96)).astype(np.float32)

    def jfn(s, d):
        dist, _ = jax_nearest(s, d)
        return jnp.sum(dist * _j(g))

    jd, ji = jax_nearest(_j(src), _j(dst))
    jgs, jgd = jax.grad(jfn, argnums=(0, 1))(_j(src), _j(dst))
    s, d = _t(src).requires_grad_(True), _t(dst).requires_grad_(True)
    dist, idx = nearest_neighbor(s, d)
    (dist * _t(g)).sum().backward()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    _close(dist.detach(), jd)
    _close(s.grad, jgs)
    _close(d.grad, jgd)
    assert bool((s.grad[:, :5] == 0).all())


@pytest.mark.parametrize("sigmas", [True, False])
def test_chamfer_matches_jax(sigmas):
    """chamfer_probabilistic (loss, chamfer_pure, chamfer_weighted) and its
    gradients in the keypoints and sigmas; single_side_chamfer,
    point_on_surface and keypoint_on_pc: rel 1e-5."""
    rng = np.random.default_rng(5)
    a, b = _grid(rng, (B, M, 3)), _grid(rng, (B, M, 3))
    sa = rng.uniform(0.1, 2, (B, M)).astype(np.float32)
    sb = rng.uniform(0.1, 2, (B, M)).astype(np.float32)
    pc = _grid(rng, (B, N, 3))
    sn = rng.normal(size=(B, N, S)).astype(np.float32)

    def jfn(a, b, sa, sb):
        out = jlosses.chamfer_probabilistic(a, b, sa if sigmas else None,
                                            sb if sigmas else None)
        on = (jnp.mean(jlosses.single_side_chamfer(a, _j(pc)))
              + jnp.mean(jlosses.point_on_surface(b, _j(pc), _j(sn))))
        return out.loss + on, (out, on)

    (_, (jout, jon)), jg = jax.value_and_grad(
        jfn, argnums=(0, 1, 2, 3), has_aux=True)(_j(a), _j(b), _j(sa),
                                                 _j(sb))
    ta, tb, tsa, tsb = (_t(x).requires_grad_(True) for x in (a, b, sa, sb))
    out = losses.chamfer_probabilistic(ta, tb, tsa if sigmas else None,
                                       tsb if sigmas else None)
    on = (losses.single_side_chamfer(ta, _t(pc)).mean()
          + losses.point_on_surface(tb, _t(pc), _t(sn)).mean())
    (out.loss + on).backward()
    for o, r in zip(out, jout):
        _close(o.detach(), r)
    _close(on.detach(), jon)
    for t, r in zip((ta, tb, tsa, tsb), jg):
        if t.grad is None:
            assert not np.asarray(r).any()
        else:
            _close(t.grad, r)
    _close(losses.keypoint_on_pc(_t(a), _t(pc)),
           jlosses.keypoint_on_pc(_j(a), _j(pc)))
    _close(losses.keypoint_on_pc(_t(a), _t(pc), _t(sn)),
           jlosses.keypoint_on_pc(_j(a), _j(pc), _j(sn)))


# ------------------------------------------------------ scatter-max ----

@pytest.mark.parametrize("backend", ["fast", "native"])
@pytest.mark.parametrize("ties", [False, True])
def test_masked_scatter_max_grad_matches_jax(backend, ties):
    """The gradient of the masked scatter-max against usip_tpu's: 'fast'
    splits a cell's cotangent among tied maxima, 'native' gives it to the
    first; empty nodes (3 of 16) pass none. Exact."""
    rng = np.random.default_rng(6)
    c, m = 8, 16
    f = rng.normal(size=(B, N, c)).astype(np.float32)
    if ties:
        f = np.round(f * 2) / 2           # few distinct values per cell
        f[:, 1::3] = f[:, ::3][:, :f[:, 1::3].shape[1]]
    ids = rng.integers(0, m - 3, size=(B, N))
    g = rng.normal(size=(B, m, c)).astype(np.float32)

    def jfn(x):
        return jnp.sum(jax_scatter_max(x, _j(ids).astype(jnp.int32), m,
                                       backend) * _j(g))

    jgrad = jax.grad(jfn)(_j(f))
    x = _t(f).requires_grad_(True)
    out = masked_scatter_max(x, _t(ids), m, backend)
    (out * _t(g)).sum().backward()
    np.testing.assert_array_equal(
        out.detach().numpy(),
        np.asarray(jax_scatter_max(_j(f), _j(ids).astype(jnp.int32), m,
                                   backend)))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), rtol=1e-6,
                               atol=0)
    # one point a (node, channel) cell takes the cotangent, or under 'fast'
    # every tied maximum
    cells = sum(len(np.unique(ids[i])) for i in range(B)) * c
    nonzero = int((np.asarray(jgrad) != 0).sum())
    assert nonzero > cells if ties and backend == "fast" else nonzero == cells


# -------------------------------------------------------- batchnorm ----

def test_batchnorm_train_matches_jax():
    """Train-mode BatchNorm: output, gradients in the input, scale and
    bias, and the running statistics after the update (momentum 0.3):
    rel 1e-5 (the statistics within 1e-6)."""
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(B, 40, 5, 6)) * 3 + 1).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    bias = rng.normal(size=6).astype(np.float32)
    mean0 = rng.normal(size=6).astype(np.float32)
    var0 = rng.uniform(0.5, 2, 6).astype(np.float32)
    jbn = JaxBatchNorm(6)
    variables = {"params": {"scale": _j(scale), "bias": _j(bias)},
                 "batch_stats": {"mean": _j(mean0), "var": _j(var0)}}

    def jfn(params, xx):
        y, mut = jbn.apply({"params": params,
                            "batch_stats": variables["batch_stats"]}, xx,
                           use_running_average=False, momentum=0.3,
                           mutable=["batch_stats"])
        return jnp.sum(y * _j(g)), (y, mut["batch_stats"])

    (_, (jy, jstats)), (jgp, jgx) = jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True)(variables["params"], _j(x))
    bn = BatchNorm(6)
    set_bn_momentum(bn, 0.3)
    with torch.no_grad():
        bn.weight.copy_(_t(scale))
        bn.bias.copy_(_t(bias))
        bn.running_mean.copy_(_t(mean0))
        bn.running_var.copy_(_t(var0))
    xt = _t(x).requires_grad_(True)
    y = bn.train()(xt)
    (y * _t(g)).sum().backward()
    _close(y.detach(), jy, atol=1e-5)
    _close(xt.grad, jgx, atol=1e-5)
    _close(bn.weight.grad, jgp["scale"], atol=1e-5)
    _close(bn.bias.grad, jgp["bias"], atol=1e-5)
    _close(bn.running_mean, jstats["mean"], rtol=1e-6, atol=1e-6)
    _close(bn.running_var, jstats["var"], rtol=1e-6, atol=1e-6)
    assert int(bn.num_batches_tracked) == 1


@pytest.mark.parametrize("epoch,step,decay", [
    (0, 10, 0.5), (1, 10, 0.5), (10, 10, 0.5), (25, 10, 0.6), (200, 10, 0.5),
    (7, None, 0.5), (7, 0, 0.5), (None, 3, 0.5)])
def test_bn_momentum_schedule_matches_jax(epoch, step, decay):
    ref = float(jax_bn_schedule(0.1, epoch, step, decay))
    assert bn_momentum_schedule(0.1, epoch, step, decay) == pytest.approx(
        ref, rel=1e-6)


def test_lr_schedule_and_adam():
    """lr_at_epoch with its 1e-5 floor; set_learning_rate reaches every
    group; make_adam is Adam(0.9, 0.999, eps 1e-8), no weight decay."""
    assert lr_at_epoch(1e-3, 0, 40, 0.5) == 1e-3
    assert lr_at_epoch(1e-3, 40, 40, 0.5) == 5e-4
    assert lr_at_epoch(1e-3, 80, 40, 0.5) == 2.5e-4
    assert lr_at_epoch(1e-3, 10000, 40, 0.5) == 1e-5
    opt = make_adam([torch.nn.Parameter(torch.zeros(3))], 1e-3)
    group = opt.param_groups[0]
    assert (group["betas"], group["eps"], group["weight_decay"]) == \
        ((0.9, 0.999), 1e-8, 0.0)
    set_learning_rate(opt, 1e-5)
    assert group["lr"] == 1e-5


# ------------------------------------------------------- train step ----

def _setup(seed=0, overrides=OVERRIDES, grid=False):
    """Both packages' configs, a parent batch (on a 1/8 grid if ``grid``),
    the JAX model and its variables, and the port's detector holding the
    same numbers."""
    jcfg = jax_get_config("kitti", **overrides)
    cfg = get_config("kitti", **overrides)
    rng = np.random.default_rng(seed)
    pc = rng.normal(0, 3, (B, P, 3)).astype(np.float32)
    if grid:
        pc = np.round(pc * 8) / 8
    sn = rng.normal(size=(B, P, S)).astype(np.float32)
    sd = seeded_state_dict(cfg.detector, seed)
    jmodel = JaxDetector(jcfg.detector)
    init = jmodel.init(jax.random.PRNGKey(0), _j(pc[:1, :N]),
                       _j(sn[:1, :N]), _j(pc[:1, :M]), train=False)
    variables = convert_detector_state_dict(sd, init)
    det = Detector(cfg.detector)
    det.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, variables)), strict=True)
    return jcfg, cfg, pc, sn, jmodel, variables, det


def _port_names(tree):
    """A JAX ``{'params', 'batch_stats'}`` tree in the port's names and
    layout."""
    return state_dict_from_jax(jax.tree_util.tree_map(np.asarray, tree))


def _check_grads(det, jgrads, stats):
    """Every parameter's gradient within 1e-4 x the largest |gradient|."""
    ref = _port_names({"params": jgrads, "batch_stats": stats})
    gmax = max(float(v.abs().max()) for k, v in ref.items()
               if not k.endswith(("running_mean", "running_var",
                                  "num_batches_tracked")))
    assert gmax > 0
    for name, p in det.named_parameters():
        got = np.zeros(p.shape, np.float32) if p.grad is None else \
            p.grad.numpy()
        err = np.abs(got - ref[name].numpy()).max()
        assert err <= 1e-4 * gmax, (name, err, gmax)


def test_train_step_matches_jax():
    """One full train step (dropout, FPS nodes, shared augment with jitter,
    the GT transform, the siamese forward in train mode, losses, backward,
    Adam) against usip_tpu's make_detector_train_step with the same draws:
    the loss and every metric rel 1e-5; the gradients within 1e-4 x max|g|
    (from usip_tpu's loss on the same prepared inputs); the parameters
    after one Adam step within 1e-5 wherever the gradient is well above the
    two packages' rounding noise (1e-3 x max|g|; elsewhere Adam's first
    step moves a parameter by at most lr = 1e-3 on either side, in a
    direction the noise decides); the BatchNorm statistics within 1e-6.
    These draws put no ReLU input within rounding noise of 0: where one
    lies there (PRNGKey(11) puts one at 1.1e-6 in mlp2), that unit's
    gradient flips between the packages and every gradient below it moves
    by ~1e-3 x max|g|."""
    jcfg, cfg, pc, sn, jmodel, variables, det = _setup()
    batch = jsteps.ParentBatch(pc=_j(pc), sn=_j(sn))
    key, epoch = jax.random.PRNGKey(12), 3
    state = JaxTrainState.create(variables, jax_make_adam(jcfg.train.lr))
    new_state, jmetrics = jax.jit(jsteps.make_detector_train_step(
        jcfg, jmodel))(state, batch, key, jnp.asarray(epoch))

    # usip_tpu's gradients, from the body of its train step
    src, dst, gt = jsteps._prepare_detector_inputs(key, batch, jcfg, True)
    momentum = jax_bn_schedule(jcfg.train.bn_momentum, jnp.asarray(epoch),
                               jcfg.train.bn_momentum_decay_step,
                               jcfg.train.bn_momentum_decay)

    def jloss(params):
        (so, do), _ = jsteps._siamese_apply(
            jmodel, {"params": params, "batch_stats": state.batch_stats},
            src, dst, train=True, bn_momentum=momentum)
        return jsteps._detector_losses(jcfg, so, do, src[0], src[1], dst[0],
                                       dst[1], gt)[0]

    jgrads = jax.jit(jax.grad(jloss))(state.params)

    tstate = TrainState.create(det, cfg.train.lr)
    metrics = steps.make_detector_train_step(cfg)(
        tstate, steps.ParentBatch(_t(pc), _t(sn)), epoch,
        draws=_jax_draws(key, jcfg))
    assert tstate.step == 1
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        _close(metrics[k], jmetrics[k], what=k)
    assert float(metrics["loss"]) != 0

    _check_grads(det, jgrads, new_state.batch_stats)
    after = _port_names(new_state.variables)
    before = _port_names(variables)
    ref_g = _port_names({"params": jgrads,
                         "batch_stats": new_state.batch_stats})
    gmax = max(float(ref_g[n].abs().max()) for n, _ in
               det.named_parameters())
    for name, t in det.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        got, ref = t.numpy(), np.asarray(after[name])
        if name.endswith(("running_mean", "running_var")):
            _close(got, ref, rtol=1e-6, atol=1e-6, what=name)
            continue
        sure = (ref_g[name].abs() > 1e-3 * gmax).numpy()
        np.testing.assert_allclose(got[sure], ref[sure], rtol=0, atol=1e-5,
                                   err_msg=name)
        moved = np.abs(got - np.asarray(before[name]))
        assert (moved <= 1e-3 * (1 + 1e-4)).all(), name


# the bf16 trunk with an identity augmentation and parents on a 1/8 grid: the
# fp32 point->node distances are then exact in both packages, so the bf16
# assignment (round, then clamp, first minimum) is the same in both and the
# rest of the difference is the bf16 arithmetic of the trunk
BF16_OVERRIDES = {**OVERRIDES, "detector.compute_dtype": "bfloat16",
                  "augment.rot_horizontal": False, "augment.rot_3d": False,
                  "augment.rot_perturbation": False, "augment.jitter": False,
                  "augment.translation_perturbation": False,
                  "augment.aug_scale_low": 1.0, "augment.aug_scale_high": 1.0,
                  "augment.gt_scale_thre": 0.0, "augment.gt_shift_thre": 0.0}


# from _bf16_step over the seeds (parents, key) (0, 12), (1, 11), (2, 13),
# (4, 21), the port against usip_tpu without excess precision: keypoints
# max 0.07-1.1e-3, median 0.7e-6-6.3e-5 x max|ref| (usip_tpu's fp32
# forward: median 1.0-2.2e-3); sigmas max 0.16-3.7e-3, median 1.8e-6-2.1e-4
# (fp32: median 2.2-7.4e-3); the loss within 9.0e-4 relative, every metric
# within 1.5e-3 (grad_norm; the rest within 9.0e-4); the running statistics
# within 1.2e-4 x max|stat|; the cosine between the gradients 0.99913-0.99999
TOLERANCES_BF16 = {"forward": [(0, 0), (2e-3, 2e-4), (6e-3, 5e-4)],
                   "loss": 2e-3, "metric": 3e-3, "stats": 5e-4, "cos": 0.998}


def test_train_step_marks_its_parts():
    """The step's five parts are spans, each opened once, in order
    (``usip.step.inputs``, ``.forward``, ``.losses``, ``.backward``,
    ``.optimizer``), and recording them changes nothing: from the same
    start and generator seed the step gives the same metrics and weights
    with and without the record."""
    _, cfg, pc, sn, _, _, det = _setup()
    start = copy.deepcopy(det.state_dict())
    step = steps.make_detector_train_step(cfg)
    batch = steps.ParentBatch(_t(pc), _t(sn))
    runs = []
    for record in (False, True):
        det.load_state_dict(start)
        state = TrainState.create(det, cfg.train.lr)
        with recording() if record else contextlib.nullcontext() as rec:
            metrics = step(state, batch, 3,
                           generator=torch.Generator().manual_seed(0))
        runs.append((metrics, copy.deepcopy(det.state_dict())))
    assert rec.names() == ["usip.step." + p for p in (
        "inputs", "forward", "losses", "backward", "optimizer")]
    (m0, w0), (m1, w1) = runs
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(w0[k], w1[k]) for k in w0)


def _flat_grads(grads, names):
    return torch.cat([torch.as_tensor(np.asarray(grads[n])).flatten()
                      for n in names])


def _exact_bf16(fn, *args):
    """``fn(*args)`` compiled without XLA's excess precision: every
    operation rounds to its dtype as the code is written (as the port's
    eager operations do). By default XLA's CPU backend keeps some bf16
    intermediates at a higher precision."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _bf16_step(seed, key):
    """One bf16 train step in both packages from the same weights, parents
    (on the grid) and draws, measured against usip_tpu's: for each side's
    anchors, keypoints and sigmas the port's max and median |error| and
    usip_tpu's own fp32 forward's median |difference| (x max|ref|); each
    metric's relative error; the worst running statistic's error (x
    max|stat|); the cosine between the two gradients."""
    jcfg, cfg, pc, sn, jmodel, variables, det = _setup(seed, BF16_OVERRIDES,
                                                      grid=True)
    batch = jsteps.ParentBatch(pc=_j(pc), sn=_j(sn))
    epoch = 3
    state = JaxTrainState.create(variables, jax_make_adam(jcfg.train.lr))
    new_state, jmetrics = _exact_bf16(jsteps.make_detector_train_step(
        jcfg, jmodel), state, batch, key, jnp.asarray(epoch))

    # usip_tpu's forward and gradients, from the body of its train step
    src, dst, gt = jsteps._prepare_detector_inputs(key, batch, jcfg, True)
    momentum = jax_bn_schedule(jcfg.train.bn_momentum, jnp.asarray(epoch),
                               jcfg.train.bn_momentum_decay_step,
                               jcfg.train.bn_momentum_decay)

    def jloss(params, model):
        (so, do), _ = jsteps._siamese_apply(
            model, {"params": params, "batch_stats": state.batch_stats},
            src, dst, train=True, bn_momentum=momentum)
        return jsteps._detector_losses(jcfg, so, do, src[0], src[1], dst[0],
                                       dst[1], gt)[0], (so, do)

    (_, jout), jgrads = _exact_bf16(
        lambda p: jax.value_and_grad(jloss, has_aux=True)(p, jmodel),
        state.params)
    fp32 = JaxDetector(jax_get_config("kitti", **{
        **BF16_OVERRIDES, "detector.compute_dtype": "float32"}).detector)
    _, jout32 = jax.jit(jloss, static_argnums=1)(state.params, fp32)

    tstate = TrainState.create(det, cfg.train.lr)
    draws = _jax_draws(key, jcfg)
    with torch.no_grad():
        psrc, pdst, _ = steps._prepare_detector_inputs(
            steps.ParentBatch(_t(pc), _t(sn)), cfg, True, draws)
        # on a copy: a train-mode forward updates the running statistics
        pout = steps._siamese_apply(copy.deepcopy(det), psrc, pdst, True,
                                    float(momentum))
    metrics = steps.make_detector_train_step(cfg)(
        tstate, steps.ParentBatch(_t(pc), _t(sn)), epoch, draws=draws)
    assert set(metrics) == set(jmetrics)

    forward = []
    for side in range(2):
        for i in range(3):
            ref = np.asarray(jout[side][i])
            scale = np.abs(ref).max()
            err = np.abs(pout[side][i].numpy() - ref) / scale
            far = np.abs(np.asarray(jout32[side][i]) - ref) / scale
            forward.append((err.max(), np.median(err), np.median(far)))
    rel = {k: abs(float(metrics[k]) - float(jmetrics[k]))
           / abs(float(jmetrics[k])) for k in jmetrics}
    after = _port_names(new_state.variables)
    stats = max(float((t - after[n]).abs().max() / after[n].abs().max())
                for n, t in det.state_dict().items()
                if n.endswith(("running_mean", "running_var")))
    ref_g = _port_names({"params": jgrads,
                         "batch_stats": new_state.batch_stats})
    # the conv biases ahead of a train-mode BatchNorm have an exact
    # gradient of 0: what either package gives there is rounding noise
    before_bn = {f"{n.rsplit('.', 2)[0]}.conv.bias" for n, _ in
                 det.named_parameters() if n.endswith("norm.weight")}
    names = [n for n, _ in det.named_parameters() if n not in before_bn]
    port_g = {n: p.grad for n, p in det.named_parameters()}
    cos = float(torch.nn.functional.cosine_similarity(
        _flat_grads(port_g, names), _flat_grads(ref_g, names), 0))
    return forward, rel, stats, cos


def test_train_step_bf16_matches_jax():
    """One train step with the bf16 trunk (bf16 assignment, bf16 matmuls
    feeding train-mode BatchNorm, the casts) against usip_tpu's
    make_detector_train_step with the same draws, compiled without XLA's
    excess precision (``_exact_bf16``): every operation then rounds to its
    dtype as the code is written, as the port's eager operations do. With
    the excess precision (XLA's default) the step moves as far as an fp32
    trunk would (the port against it: keypoints median 1.0-1.7e-3 x
    max|ref|, fp32 against it 1.0-2.1e-3), and a train-mode BatchNorm
    backward amplifies such a rounding difference (gradient cosine
    0.966-0.980), so that step cannot tell a right bf16 trunk from a wrong
    one.

    Tolerances from the spread over four seeds (TOLERANCES_BF16's comment):
    anchors identical (the grid makes the bf16 assignment exact in both);
    keypoints and sigmas within the max / median tolerances, which
    usip_tpu's own fp32 trunk misses (checked, so the test tells a bf16
    trunk from an fp32 one); the loss, every metric, the running statistics
    and the gradients' cosine over every parameter whose gradient is not
    rounding noise."""
    forward, rel, stats, cos = _bf16_step(0, jax.random.PRNGKey(12))
    t = TOLERANCES_BF16
    for n, (emax, emed, far) in enumerate(forward):
        tmax, tmed = t["forward"][n % 3]
        assert emax <= tmax and emed <= tmed, (n, emax, emed)
        if n % 3:
            assert far > tmed, (n, far)
    for k, r in rel.items():
        assert r <= (t["loss"] if k == "loss" else t["metric"]), (k, r)
    assert stats <= t["stats"], stats
    assert cos >= t["cos"], cos


def test_loss_fn_matches_jax():
    """make_detector_loss_fn (eval-mode BatchNorm, statistics untouched):
    loss and metrics rel 1e-5, gradients within 1e-4 x max|g|."""
    jcfg, cfg, pc, sn, jmodel, variables, det = _setup(1)
    batch = jsteps.DetectorBatch(_j(pc[:, :N]), _j(sn[:, :N]),
                                 _j(pc[:, -N:]), _j(sn[:, -N:]))
    key = jax.random.PRNGKey(12)
    jfn = jsteps.make_detector_loss_fn(jcfg, jmodel)
    (jl, jm), jg = jax.jit(jax.value_and_grad(jfn, has_aux=True),
                           static_argnums=4)(
        variables["params"], variables["batch_stats"], batch, key, 0)
    before = {k: v.clone() for k, v in det.state_dict().items()}
    loss, metrics = steps.make_detector_loss_fn(cfg, det)(
        steps.DetectorBatch(*(_t(np.asarray(x)) for x in batch)), 0,
        draws=_jax_draws(key, jcfg))
    loss.backward()
    _close(loss.detach(), jl)
    for k in jm:
        _close(metrics[k], jm[k], what=k)
    _check_grads(det, jg, variables["batch_stats"])
    for k, v in det.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_eval_step_matches_jax():
    """make_detector_eval_step: no augment, running statistics, the same
    metrics rel 1e-5."""
    jcfg, cfg, pc, sn, jmodel, variables, det = _setup(2)
    batch = jsteps.ParentBatch(pc=_j(pc), sn=_j(sn))
    key = jax.random.PRNGKey(13)
    state = JaxTrainState.create(variables, jax_make_adam(jcfg.train.lr))
    jm = jsteps.make_detector_eval_step(jcfg, jmodel)(state, batch, key)
    metrics = steps.make_detector_eval_step(cfg)(
        TrainState.create(det, cfg.train.lr),
        steps.ParentBatch(_t(pc), _t(sn)), draws=_jax_draws(key, jcfg, False))
    assert set(metrics) == set(jm)
    for k in jm:
        _close(metrics[k], jm[k], what=k)


def test_siamese_topk_and_dropout_match_jax():
    """The 'topk' parent mode with JAX's subset rows, and the point
    dropout with JAX's draws: the same clouds, bit for bit."""
    jcfg = jax_get_config("kitti", **{**OVERRIDES,
                                      "data.device_sampling_mode": "topk"})
    cfg = get_config("kitti", **{**OVERRIDES,
                                 "data.device_sampling_mode": "topk"})
    pc, sn = _cloud(8, n=P)
    key = jax.random.PRNGKey(14)
    ref = jsteps._as_siamese(key, jsteps.ParentBatch(_j(pc), _j(sn)), jcfg)
    k_src, k_dst = jax.random.split(key)
    idx = [np.asarray(jax.lax.top_k(jax.random.uniform(k, (B, P)), N)[1])
           for k in (k_src, k_dst)]
    out = steps._as_siamese(steps.ParentBatch(_t(pc), _t(sn)), cfg,
                            tuple(map(_t, idx)))
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))

    d = _jax_draws(key, jcfg).dropout
    ref = jsteps._random_point_dropout(jax.random.split(key, 7)[1],
                                       [(ref[0], ref[1]), (ref[2], ref[3])],
                                       0.5)
    got = steps._random_point_dropout([(out[0], out[1]), (out[2], out[3])],
                                      d)
    for gp, rp in zip(got, ref):
        for o, r in zip(gp, rp):
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_train_steps_from_a_generator():
    """Three steps drawing from one generator (no injected draws): finite
    metrics with usip_tpu's keys plus grad_norm, parameters and BatchNorm
    statistics that move, the step count; the same seed repeats a step."""
    _, cfg, pc, sn, _, _, det = _setup(3)
    start = {k: v.clone() for k, v in det.state_dict().items()}
    state = TrainState.create(det, cfg.train.lr)
    step = steps.make_detector_train_step(cfg)
    g = torch.Generator().manual_seed(0)
    batch = steps.ParentBatch(_t(pc), _t(sn))
    for epoch in range(3):
        metrics = step(state, batch, epoch, generator=g)
        assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert state.step == 3 and "grad_norm" in metrics
    moved = [k for k, v in det.state_dict().items()
             if not torch.equal(v, start[k])]
    assert any(k.endswith("conv.weight") for k in moved)
    assert any(k.endswith("running_var") for k in moved)
    first = []
    for _ in range(2):
        det.load_state_dict(start)
        state = TrainState.create(det, cfg.train.lr)
        first.append(step(state, batch, 0,
                          generator=torch.Generator().manual_seed(1))["loss"])
    assert torch.equal(*first)
