"""The port's descriptor pieces (the ball query with random priorities, the
D-wide distances, the descriptor network and its losses) against
usip_tpu's, on the CPU at a small width.

Inputs come from numpy seeds; the random priorities and the CGF loss's
uniforms are JAX's own draws, handed to the port. Weights are seeded in the
reference layout, put into the JAX descriptor, and carried back to the port
through ``usip_tpu.train.torch_import.export_descriptor_state_dict`` with
``strict=True``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from usip_tpu import losses as jlosses
from usip_tpu.config import get_config as jax_get_config
from usip_tpu.models import Descriptor as JaxDescriptor
from usip_tpu.ops import ball_query as jax_ball_query
from usip_tpu.ops.geometry import pairwise_dist as jax_pairwise_dist
from usip_tpu.ops.geometry import pairwise_sqdist as jax_pairwise_sqdist
from usip_tpu.train.torch_import import (convert_descriptor_state_dict,
                                         export_descriptor_state_dict)
from usip_tpu_torch import losses
from usip_tpu_torch.config import get_config
from usip_tpu_torch.models import Descriptor
from usip_tpu_torch.ops import ball_query, pairwise_dist, pairwise_sqdist
from usip_tpu_torch.ops.geometry import cross_dot, sq_norm
from usip_tpu_torch.weights import (load_descriptor_weights,
                                    seeded_descriptor_state_dict,
                                    state_dict_from_jax)

torch.set_num_threads(1)

B, N, M, K, S = 2, 512, 32, 16, 4
# the KITTI descriptor preset at a small width, fp32, exact selection
SMALL = {"data.input_pc_num": N, "data.node_num": M,
         "descriptor.descriptor_len": 32, "descriptor.ball_nsamples": K,
         "descriptor.ball_radius": 2.0,
         "descriptor.compute_dtype": "float32",
         "descriptor.ball_method": "exact",
         "descriptor.ball_compute_dtype": "float32"}


def _t(x):
    return torch.from_numpy(np.array(x))


def _cloud(seed, b=B, n=N, m=M):
    """A gaussian cloud (sigma 3), normals, and keypoints near its points:
    balls near the centre overflow K, balls far out hold a few points, the
    last keypoint of each cloud is far from everything (an empty ball)."""
    rng = np.random.default_rng(seed)
    pc = rng.normal(0, 3, (b, n, 3)).astype(np.float32)
    sn = rng.normal(size=(b, n, S)).astype(np.float32)
    kp = pc[:, :m] + rng.normal(0, 0.3, (b, m, 3)).astype(np.float32)
    kp[:, -1] = 100.0
    return pc, sn, kp


# ------------------------------------------------------------ ball query ----

@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_ball_query_exact_matches_jax(seed, bf16):
    """usip_tpu's ball_query(method='exact') with JAX's priorities: idx,
    valid and counts bit-identical, with overflowing, short and empty balls;
    in bf16 mode (distances rounded to bf16, then clamped; radius^2 in bf16;
    priorities rounded to bf16, many of them tied) as in fp32."""
    pc, _, kp = _cloud(seed)
    key = jax.random.PRNGKey(seed + 5)
    prio = jax.random.uniform(key, (B, N))
    ref = jax_ball_query(jnp.asarray(pc), jnp.asarray(kp), 2.0, K, key=key,
                         method="exact",
                         compute_dtype=jnp.bfloat16 if bf16 else None)
    out = ball_query(_t(pc), _t(kp), 2.0, K, _t(prio), round_bf16=bf16)
    counts = np.asarray(ref.counts)
    assert (counts == K).any() and ((counts > 0) & (counts < K)).any()
    assert (counts[:, -1] == 0).all()
    assert out.idx.dtype == torch.int32 and out.counts.dtype == torch.int32
    np.testing.assert_array_equal(out.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(out.counts.numpy(), counts)
    if bf16:  # bf16 priorities tie
        p16 = np.asarray(prio.astype(jnp.bfloat16).astype(jnp.float32))
        assert len(np.unique(p16)) < p16.size // 2


def test_ball_query_auto_bf16_matches_jax_away_from_ties():
    """The KITTI preset's selection, ``method='auto'`` with bf16 balls at N
    >= 4096, where usip_tpu runs ``lax.approx_min_k``. On the CPU (JAX,
    (64, 16384) rows, a third +inf, k = 64) approx_min_k and lax.top_k
    pick identical indices on fp32 uniform priorities, but on
    the same priorities cast to bf16 the values are identical while the
    indices differ in 61 of 64 rows, all among tied priorities. The port
    selects exactly, so it is held to the same counts and validity, the
    same selected priority values, and the same index set below each row's
    largest selected priority (above it a tie decides)."""
    n = 4096
    rng = np.random.default_rng(7)
    pc = rng.normal(0, 6, (B, n, 3)).astype(np.float32)
    kp = pc[:, :M] + rng.normal(0, 0.3, (B, M, 3)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    prio = jax.random.uniform(key, (B, n))
    ref = jax_ball_query(jnp.asarray(pc), jnp.asarray(kp), 2.0, K, key=key,
                         method="auto", compute_dtype=jnp.bfloat16)
    out = ball_query(_t(pc), _t(kp), 2.0, K, _t(prio), method="auto",
                     round_bf16=True)
    np.testing.assert_array_equal(out.counts.numpy(), np.asarray(ref.counts))
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    p16 = np.asarray(prio.astype(jnp.bfloat16).astype(jnp.float32))
    got_i, ref_i = out.idx.numpy(), np.asarray(ref.idx)
    valid = out.valid.numpy()
    differ = 0
    for bi in range(B):
        for mi in range(M):
            v = valid[bi, mi]
            gv = np.sort(p16[bi, got_i[bi, mi, v]])
            rv = np.sort(p16[bi, ref_i[bi, mi, v]])
            np.testing.assert_array_equal(gv, rv)
            if not v.any():
                continue
            top = gv[-1]
            below = lambda i: set(i[p16[bi, i] < top])  # noqa: E731
            assert below(got_i[bi, mi, v]) == below(ref_i[bi, mi, v])
            differ += int(not np.array_equal(got_i[bi, mi], ref_i[bi, mi]))
    # the comparison has ties to step over: some rows' orders differ
    assert differ > 0


def test_ball_query_draws_from_a_generator():
    """Without priorities the ball query draws them from the generator: the
    same seed repeats the selection, every selected point lies in its ball,
    and another seed selects other points from the overflowing balls."""
    pc, _, kp = _cloud(3)
    run = lambda s: ball_query(  # noqa: E731
        _t(pc), _t(kp), 2.0, K, generator=torch.Generator().manual_seed(s))
    a, b, c = run(0), run(0), run(1)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a.idx, c.idx)
    g = np.take_along_axis(pc[:, None], a.idx.long().numpy()[..., None], 2)
    d = np.linalg.norm(g - kp[:, :, None], axis=-1)
    assert (d[a.valid.numpy()] <= 2.0 + 1e-5).all()


def test_pairwise_distances_match_jax():
    """D-wide rows (one fp32 product) within 1e-5 of usip_tpu's einsum at
    HIGHEST precision, with a zero gradient at a zero distance; 3-wide rows
    keep the elementwise form the kernels reproduce, bit for bit."""
    rng = np.random.default_rng(4)
    a = rng.normal(size=(B, 24, 32)).astype(np.float32)
    b = rng.normal(size=(B, 20, 32)).astype(np.float32)
    b[:, 0] = a[:, 0]
    np.testing.assert_allclose(
        pairwise_sqdist(_t(a), _t(b)).numpy(),
        np.asarray(jax_pairwise_sqdist(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-5, atol=1e-5)
    ta = _t(a).requires_grad_(True)
    d = pairwise_dist(ta, _t(b))
    ref = jax_pairwise_dist(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(d.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    w = rng.normal(size=d.shape).astype(np.float32)
    (d * _t(w)).sum().backward()
    jg = jax.grad(lambda x: jnp.sum(jax_pairwise_dist(
        x, jnp.asarray(b)) * w))(jnp.asarray(a))
    assert np.isfinite(ta.grad.numpy()).all()
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-4)
    p, q = _t(a[..., :3]), _t(b[..., :3])
    assert torch.equal(pairwise_sqdist(p, q), (
        sq_norm(p)[..., :, None] - 2.0 * cross_dot(p, q)
        + sq_norm(q)[..., None, :]).clamp_min(0.0))


# ------------------------------------------------------------ descriptor ----

def _descriptors(global_context, seed=0, **extra):
    """Both packages' descriptors holding the same seeded weights."""
    over = {**SMALL, "descriptor.use_global_context": global_context,
            **extra}
    jcfg = jax_get_config("kitti", role="descriptor", **over)
    cfg = get_config("kitti", role="descriptor", **over)
    sd = seeded_descriptor_state_dict(cfg.descriptor, seed)
    jmodel = JaxDescriptor(jcfg.descriptor)
    pc, sn, kp = _cloud(0)
    init = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(pc),
                       jnp.asarray(sn), jnp.asarray(kp),
                       key=jax.random.PRNGKey(1), train=False)
    variables = convert_descriptor_state_dict(sd, init)
    model = Descriptor(cfg.descriptor)
    model.load_state_dict({k: _t(v) for k, v in export_descriptor_state_dict(
        jax.tree_util.tree_map(np.asarray, variables)).items()}, strict=True)
    return jcfg, cfg, jmodel, variables, model


@pytest.mark.parametrize("global_context", [False, True])
def test_descriptor_forward_matches_jax(global_context):
    """Eval forward, fp32, JAX's priorities: descriptors within 1e-5, unit
    length, and the ball features identical; the gradient of a projection
    of the descriptors within 1e-4 x max|g| for every parameter, with short
    balls padded by repetition, whose maxima tie (``amax`` splits their
    gradient evenly, as ``jnp.max`` does)."""
    _, _, jmodel, variables, model = _descriptors(global_context)
    model.eval()
    pc, sn, kp = _cloud(1)
    key = jax.random.PRNGKey(4)
    prio = jax.random.uniform(key, (B, N))
    (jdesc, jfeats) = jmodel.apply(variables, jnp.asarray(pc),
                                   jnp.asarray(sn), jnp.asarray(kp), key=key,
                                   train=False)
    desc, feats = model(_t(pc), _t(sn), _t(kp), _t(prio))
    np.testing.assert_array_equal(feats.numpy(), np.asarray(jfeats))
    np.testing.assert_allclose(desc.detach().numpy(), np.asarray(jdesc),
                               rtol=1e-5, atol=1e-5)
    norms = desc.detach().norm(dim=-1).numpy()
    np.testing.assert_allclose(norms[:, :-1], 1.0, atol=1e-4)

    w = np.random.default_rng(2).normal(size=desc.shape).astype(np.float32)
    (desc * _t(w)).sum().backward()

    def f(params):
        d, _ = jmodel.apply({**variables, "params": params}, jnp.asarray(pc),
                            jnp.asarray(sn), jnp.asarray(kp), key=key,
                            train=False)
        return jnp.sum(d * w)

    jg = state_dict_from_jax({"params": jax.grad(f)(variables["params"]),
                              "batch_stats": variables["batch_stats"]})
    gmax = max(float(jg[n].abs().max()) for n, _ in model.named_parameters())
    assert gmax > 0
    for name, p in model.named_parameters():
        err = float((p.grad - jg[name]).abs().max())
        assert err <= 1e-4 * gmax, (name, err, gmax)


def test_descriptor_bf16_forward_near_jax():
    """The preset's bf16 trunk and bf16 balls (exact selection on both
    sides): the same balls, descriptors within bf16 rounding (5e-2 at the
    maximum, 5e-3 at the median, of unit vectors)."""
    over = {"descriptor.compute_dtype": "bfloat16",
            "descriptor.ball_compute_dtype": "bfloat16"}
    _, _, jmodel, variables, model = _descriptors(False, **over)
    model.eval()
    pc, sn, kp = _cloud(2)
    key = jax.random.PRNGKey(6)
    prio = jax.random.uniform(key, (B, N))
    jdesc, jfeats = jmodel.apply(variables, jnp.asarray(pc), jnp.asarray(sn),
                                 jnp.asarray(kp), key=key, train=False)
    with torch.no_grad():
        desc, feats = model(_t(pc), _t(sn), _t(kp), _t(prio))
    np.testing.assert_array_equal(feats.numpy(), np.asarray(jfeats))
    err = np.abs(desc.numpy() - np.asarray(jdesc))
    assert err.max() <= 5e-2 and np.median(err) <= 5e-3, (err.max(),
                                                           np.median(err))


def test_descriptor_weights_load_from_files(tmp_path):
    """A reference ``.pth`` (with the DataParallel prefix) and a usip_tpu
    descriptor ``.msgpack`` load into the port with strict=True; the
    ``.msgpack`` also restores a descriptor train state."""
    from usip_tpu.train.checkpoint import save_checkpoint
    from usip_tpu.train.state import TrainState as JaxTrainState
    from usip_tpu.train.state import make_adam
    _, cfg, _, variables, model = _descriptors(True)
    sd = model.state_dict()
    torch.save({f"module.{k}": v for k, v in sd.items()},
               tmp_path / "desc.pth")
    save_checkpoint(str(tmp_path / "desc.msgpack"),
                    JaxTrainState.create(variables, make_adam(1e-3)))
    for name in ("desc.pth", "desc.msgpack"):
        got = load_descriptor_weights(str(tmp_path / name))
        fresh = Descriptor(cfg.descriptor)
        fresh.load_state_dict(got, strict=True)
        for k, v in sd.items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(fresh.state_dict()[k], v), (name, k)
    # a usip_tpu descriptor checkpoint restores into the port's train state
    # (parameters, statistics, step; Adam's moments, zero at step 0)
    from usip_tpu_torch.train import TrainState
    from usip_tpu_torch.train.checkpoint import restore_checkpoint
    state = TrainState.create(Descriptor(cfg.descriptor), 1e-3)
    restore_checkpoint(str(tmp_path / "desc.msgpack"), state)
    assert state.step == 0
    for k, v in sd.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(state.model.state_dict()[k], v), k


# ---------------------------------------------------------------- losses ----

def _unit(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize("ties", [False, True])
def test_descriptor_losses_match_jax(ties):
    """The scan triplet, the CGF triplet (JAX's uniforms) and the matching
    accuracy: values within 1e-5 and the descriptors' gradients within 1e-5,
    on tie-free descriptors and on descriptors with repeated rows (the
    minima tie: ``amin`` splits the gradient as ``jnp.min`` does)."""
    rng = np.random.default_rng(5)
    m, c = 24, 16
    anc, pos, neg = (_unit(rng, (B, m, c)) for _ in range(3))
    if ties:
        pos[:, 1::2] = pos[:, 0::2]
        neg[:, 1::2] = neg[:, 0::2]
    sig = rng.uniform(0.1, 4.0, (B, m)).astype(np.float32)
    kp_a = rng.uniform(0, 1, (B, m, 3)).astype(np.float32)
    kp_p = kp_a + rng.normal(0, 0.05, (B, m, 3)).astype(np.float32)
    kp_p[:, :4] += 5.0  # unmatched anchors
    kw = dict(gamma=0.5, sigma_max=3.0)

    def jscan(a, p):
        loss, active = jlosses.desc_pair_scan_loss(a, p, jnp.asarray(neg),
                                                   jnp.asarray(sig), **kw)
        return jnp.sum(loss * 1.3), active

    key = jax.random.PRNGKey(8)

    def jcgf(a, p):
        loss, active = jlosses.desc_cgf_loss(
            jnp.asarray(kp_a), a, jnp.asarray(kp_p), p, jnp.asarray(sig), key,
            cgf_radius=0.1, **kw)
        return jnp.sum(loss * 1.3), active

    k1, k2, k3 = jax.random.split(key, 3)
    draws = losses.CGFDraws(_t(jax.random.uniform(k1, (B, m, m))),
                            _t(jax.random.uniform(k2, (B, m, m))),
                            _t(jax.random.uniform(k3, (B, m))))
    port = {
        "scan": lambda a, p: losses.desc_pair_scan_loss(a, p, _t(neg),
                                                        _t(sig), **kw),
        "cgf": lambda a, p: losses.desc_cgf_loss(
            _t(kp_a), a, _t(kp_p), p, _t(sig), cgf_radius=0.1, draws=draws,
            **kw),
    }
    for name, jfn in (("scan", jscan), ("cgf", jcgf)):
        (jl, jact), (ga, gp) = jax.value_and_grad(jfn, argnums=(0, 1),
                                                  has_aux=True)(
            jnp.asarray(anc), jnp.asarray(pos))
        a = _t(anc).requires_grad_(True)
        p = _t(pos).requires_grad_(True)
        loss, active = port[name](a, p)
        (loss * 1.3).sum().backward()
        np.testing.assert_allclose(float((loss * 1.3).sum().detach()),
                                   float(jl),
                                   rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(active.numpy(), np.asarray(jact),
                                   rtol=1e-6, err_msg=name)
        assert float(jl) > 0
        for g, r in ((a.grad, ga), (p.grad, gp)):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                       atol=1e-5, err_msg=name)
    acc = losses.descriptor_matching_accuracy(_t(kp_a), _t(anc), _t(kp_p),
                                              _t(pos), radius=0.1)
    ref = jlosses.descriptor_matching_accuracy(
        jnp.asarray(kp_a), jnp.asarray(anc), jnp.asarray(kp_p),
        jnp.asarray(pos), radius=0.1)
    np.testing.assert_allclose(acc.numpy(), np.asarray(ref), rtol=1e-6)
    # the oracle: descriptors that are the keypoints match every anchor
    pad = lambda k: _t(np.concatenate(  # noqa: E731
        [k, np.zeros(k.shape[:-1] + (c - 3,), np.float32)], -1))
    assert torch.equal(losses.descriptor_matching_accuracy(
        _t(kp_a), pad(kp_a), _t(kp_a), pad(kp_a), radius=0.01),
        torch.ones(B))
    # all sigmas at or above sigma_max: weights guarded, not NaN
    w = losses._sigma_weights(torch.full((B, m), 5.0), 3.0)
    assert torch.equal(w, torch.zeros(B, m))
