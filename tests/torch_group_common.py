"""Shared set-up of the grouped-trunk and SOM k > 1 training tests
(``test_torch_group_train.py``, ``test_torch_group_eval.py``): the Oxford
preset at a small width, seeded parents and weights in both packages,
usip_tpu's random draws handed to the port, and the step comparison.

Both sides start from the same seeded weights (the JAX detector's variables
reach the port through ``state_dict_from_jax``) and the same parents from a
numpy seed; the port is handed JAX's own random draws (``jax_draws``
repeats usip_tpu's key splits). usip_tpu's gradients are read from its Adam
first moment after one step (``0.1 g``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from usip_tpu.config import get_config as jax_get_config
from usip_tpu.data import augment as jaug
from usip_tpu.models import Detector as JaxDetector
from usip_tpu.train import steps as jsteps
from usip_tpu.train.state import TrainState as JaxTrainState
from usip_tpu.train.state import make_adam as jax_make_adam
from usip_tpu.train.torch_import import convert_detector_state_dict
from usip_tpu_torch.config import get_config
from usip_tpu_torch.data import augment
from usip_tpu_torch.models import Detector
from usip_tpu_torch.train import steps
from usip_tpu_torch.weights import seeded_state_dict, state_dict_from_jax

B, N, M, S, P = 2, 512, 32, 4, 640
# the Oxford preset at a small width, fp32, FPS over half the cloud
OVERRIDES = {"data.input_pc_num": N, "data.node_num": M,
             "data.parent_pc_num": P, "data.fps_subsample_ratio": 2,
             "detector.c1": 16, "detector.c2": 32, "detector.node_knn_k": 4,
             "detector.group_k": 8, "detector.group_radius": 1.0,
             "detector.compute_dtype": "float32"}


def to_torch(x):
    return torch.from_numpy(np.array(x))


def to_jax(x):
    return jnp.asarray(np.asarray(x))


def configs(grouping, **extra):
    over = {**OVERRIDES, "detector.grouping": grouping, **extra}
    return get_config("oxford", **over), jax_get_config("oxford", **over)


def som_configs(k):
    over = {**OVERRIDES, "detector.grouping": "som", "detector.k": k}
    return get_config("kitti", **over), jax_get_config("kitti", **over)


# ------------------------------------------------------------- draws ----

def node_draws(key, b, n, cfg):
    """usip_tpu.ops.sampling.sample_nodes' draws."""
    sub = max(cfg.data.node_num, n // cfg.data.fps_subsample_ratio)
    k1, k2 = jax.random.split(key)
    subset = np.stack([np.asarray(jax.random.choice(kb, n, shape=(sub,),
                                                    replace=False))
                       for kb in jax.random.split(k1, b)])
    first = np.asarray(jax.random.randint(k2, (b,), 0, sub))
    return steps.NodeDraws(to_torch(subset), to_torch(first))


def jax_draws(key, cfg, train=True):
    """Every draw of usip_tpu's _prepare_detector_inputs for B parents (the
    'slice' siamese mode draws nothing, the preset has no dropout): the
    height scale, both node samplings, the shared augment, the GT SE(3)."""
    _, _, k_height, k_node_s, k_node_d, k_shared, k_se3 = \
        jax.random.split(key, 7)
    aug = cfg.augment
    height = shared = None
    if train:
        height = to_torch(jax.random.uniform(k_height, (B,),
                                       minval=aug.height_scale_low,
                                       maxval=aug.height_scale_high))
        k_ang, k_scale, k_shift, k_jit = jax.random.split(k_shared, 4)
        jit_keys = jax.random.split(k_jit, 2)
        shapes = ((B, N, 3), (B, N, S), (B, M, 3))
        jitter = [tuple(to_torch(jax.random.normal(k, shape)) for k, shape in
                        zip(jax.random.split(jk, 3), shapes))
                  for jk in (jit_keys[:1] * 2 if aug.shared_jitter
                             else jit_keys)] if aug.jitter else None
        shared = augment.AugmentDraws(
            to_torch(jaug._sample_angles(k_ang, aug.rot_type, aug.rot_perturbation,
                                   B)),
            to_torch(jax.random.uniform(k_scale, (B,), minval=aug.aug_scale_low,
                                  maxval=aug.aug_scale_high)),
            to_torch(jax.random.uniform(k_shift, (B, 3), minval=-0.1, maxval=0.1)),
            jitter)
    k_ang, k_scale, k_shift = jax.random.split(k_se3, 3)
    se3 = augment.SE3Draws(
        to_torch(jaug._sample_angles(k_ang, aug.rot_type, aug.rot_perturbation, B)),
        to_torch(jax.random.uniform(k_scale, (B,), minval=1.0 - aug.gt_scale_thre,
                              maxval=1.0 + aug.gt_scale_thre)),
        to_torch(jax.random.uniform(k_shift, (B, 3), minval=-aug.gt_shift_thre,
                              maxval=aug.gt_shift_thre)))
    return steps.DetectorDraws(height=height,
                               nodes_src=node_draws(k_node_s, B, N, cfg),
                               nodes_dst=node_draws(k_node_d, B, N, cfg),
                               shared=shared, se3=se3)


# ------------------------------------------------------------ set-up ----

def parents(seed, blob=False):
    """B parents of P points: a gaussian scatter, and with ``blob`` four
    tight blobs of 24 points (std 0.02) far out, where FPS puts nodes whose
    small balls overflow K."""
    rng = np.random.default_rng(seed)
    pc = rng.normal(0, 3, (B, P, 3)).astype(np.float32)
    if blob:
        centres = np.array([[12, 0, 0], [-12, 0, 0], [0, 0, 12], [0, 0, -12]])
        pc[:, :96] = (np.repeat(centres, 24, axis=0)
                      + rng.normal(0, 0.02, (B, 96, 3)))
        pc = pc[:, rng.permutation(P)]
    sn = rng.normal(size=(B, P, S)).astype(np.float32)
    return pc, sn


def make_setup(cfg, jcfg, seed=0, blob=False):
    """Parents, the JAX model and its variables, and the port's detector
    holding the same numbers."""
    pc, sn = parents(seed, blob)
    jmodel = JaxDetector(jcfg.detector)
    init = jmodel.init(jax.random.PRNGKey(0), to_jax(pc[:1, :N]), to_jax(sn[:1, :N]),
                       to_jax(pc[:1, :M]), train=False)
    variables = convert_detector_state_dict(
        seeded_state_dict(cfg.detector, seed), init)
    det = Detector(cfg.detector)
    det.load_state_dict(port_names(variables), strict=True)
    return pc, sn, jmodel, variables, det


def port_names(tree):
    """A JAX ``{'params', 'batch_stats'}`` tree in the port's names."""
    return state_dict_from_jax(jax.tree_util.tree_map(np.asarray, tree))


def jax_step(jcfg, jmodel, variables, pc, sn, key, epoch):
    state = JaxTrainState.create(variables, jax_make_adam(jcfg.train.lr))
    return jax.jit(jsteps.make_detector_train_step(jcfg, jmodel))(
        state, jsteps.ParentBatch(pc=to_jax(pc), sn=to_jax(sn)), key,
        jnp.asarray(epoch))


def check_step(det, variables, new_state, metrics, jmetrics, before):
    """Metrics rel 1e-5; every gradient within 1e-5 x max|g| (usip_tpu's
    from its Adam first moment); the running statistics within 2e-5
    relative; the parameters after Adam within 1e-6 wherever the gradient
    is well above rounding noise (1e-3 x max|g|; elsewhere Adam's first
    step moves a parameter by lr in a direction the noise decides)."""
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    mu = new_state.opt_state.inner_state[0].mu
    ref_g = port_names({"params": jax.tree_util.tree_map(
        lambda m: np.asarray(m) / 0.1, mu),
        "batch_stats": new_state.batch_stats})
    gmax = max(float(ref_g[n].abs().max()) for n, _ in det.named_parameters())
    assert gmax > 0
    for name, p in det.named_parameters():
        err = float((p.grad - ref_g[name]).abs().max())
        assert err <= 1e-5 * gmax, (name, err, gmax)
    after = port_names(new_state.variables)
    for name, t in det.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), after[name].numpy(),
                                       rtol=2e-5, atol=1e-6, err_msg=name)
            continue
        sure = (ref_g[name].abs() > 1e-3 * gmax).numpy()
        np.testing.assert_allclose(t.numpy()[sure], after[name].numpy()[sure],
                                   rtol=0, atol=1e-6, err_msg=name)
        moved = np.abs(t.numpy() - before[name].numpy())
        assert (moved <= 1e-3 * (1 + 1e-4)).all(), name


# ------------------------------------------------------- train steps ----
