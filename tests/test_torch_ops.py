"""Port ops (usip_tpu_torch.ops) against usip_tpu.ops on the same inputs.

Inputs come from a numpy seed; random draws (FPS seed rows, subset indices)
are the JAX functions' own, handed to the port. On the CPU every kernel
wrapper runs its plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from usip_tpu.ops import (assign_points_to_nodes, farthest_point_sampling,
                          gather_points, knn, masked_scatter_max,
                          sample_nodes, scatter_back, segment_mean_count)
from usip_tpu.ops.pallas_kernels import fps_pallas, min_argmin_pallas
from usip_tpu_torch import ops as tops
from usip_tpu_torch.ops import kernels
from usip_tpu_torch.ops.sampling import _fps_single

torch.set_num_threads(1)

B, N, M = 2, 512, 128


def _cloud(seed, n=N, scale=10.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, n, 3)) * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


@pytest.mark.parametrize("duplicated", [False, True])
def test_fps_matches_xla_and_pallas(duplicated):
    """Plain FPS picks are identical to the XLA loop and the Pallas kernel
    (interpret mode) from JAX's seed rows, also when every point appears
    twice (argmax ties go to the lowest index)."""
    pc = _cloud(0)
    if duplicated:
        pc = np.concatenate([pc[:, : N // 2], pc[:, : N // 2]], axis=1)
    k = 128
    _, idx_ref = farthest_point_sampling(jax.random.PRNGKey(3),
                                         jnp.asarray(pc), k, backend="xla")
    idx_ref = np.asarray(idx_ref)
    first = idx_ref[:, 0]
    idx_pallas = np.asarray(fps_pallas(jnp.asarray(pc), jnp.asarray(first), k,
                                       interpret=True))
    idx = kernels.fps(_t(pc), _t(first.astype(np.int32)), k).numpy()
    np.testing.assert_array_equal(idx, idx_ref)
    np.testing.assert_array_equal(idx, idx_pallas)
    samples0, idx0 = _fps_single(_t(pc[0]), k, _t(first[:1]))
    np.testing.assert_array_equal(idx0.numpy(), idx_ref[0])
    np.testing.assert_array_equal(samples0.numpy(), pc[0][idx_ref[0]])


def test_fps_parallel_buckets_match_xla():
    """``parallel=t`` bucketing: B*t clouds, picks offset back into the
    whole cloud, identical to usip_tpu's."""
    pc, k, t = _cloud(1), 64, 2
    samples_ref, idx_ref = farthest_point_sampling(
        jax.random.PRNGKey(5), jnp.asarray(pc), k, parallel=t, backend="xla")
    idx_ref = np.asarray(idx_ref)
    kc, nc = k // t, N // t
    first = np.stack([idx_ref[:, c * kc] - c * nc for c in range(t)],
                     axis=1).reshape(B * t)
    samples, idx = tops.farthest_point_sampling(_t(pc), k, parallel=t,
                                                first=_t(first))
    np.testing.assert_array_equal(idx.numpy(), idx_ref)
    np.testing.assert_array_equal(samples.numpy(), np.asarray(samples_ref))


def test_sample_nodes_with_jax_draws():
    """sample_nodes with JAX's subset and seed rows injected gives the same
    nodes, bit for bit."""
    pc, node_num, ratio = _cloud(2), M, 2
    key = jax.random.PRNGKey(7)
    ref = np.asarray(sample_nodes(key, jnp.asarray(pc), node_num, ratio))
    # the draws of usip_tpu.ops.sampling.sample_nodes, made the same way
    sub = max(node_num, N // ratio)
    k1, k2 = jax.random.split(key)
    subset_idx = np.stack([
        np.asarray(jax.random.choice(kb, N, shape=(sub,), replace=False))
        for kb in jax.random.split(k1, B)])
    first = np.asarray(jax.random.randint(k2, (B,), 0, sub))
    nodes = tops.sample_nodes(_t(pc), node_num, ratio,
                              subset_idx=_t(subset_idx), first=_t(first))
    np.testing.assert_array_equal(nodes.numpy(), ref)


def _points_and_nodes(seed):
    # unit scale: the expansion |p|^2 - 2 p.n + |n|^2 loses absolute accuracy
    # in proportion to |p|^2, and the 1e-4 bound on the mins is absolute
    pc = _cloud(seed, scale=1.0)
    rng = np.random.default_rng(seed + 100)
    sel = np.stack([rng.choice(N, M, replace=False) for _ in range(B)])
    nodes = np.take_along_axis(pc, sel[..., None], axis=1)
    return pc, nodes


def test_min_argmin_matches_pallas_and_assignment():
    """fp32 min/argmin: ids identical to min_argmin_pallas (interpret, M=128)
    and to assign_points_to_nodes(compute_dtype=None); mins within 1e-4 of
    the Pallas kernel's (fp32 sums taken in another order)."""
    pc, nodes = _points_and_nodes(3)
    mins_ref, idx_ref = min_argmin_pallas(jnp.asarray(pc), jnp.asarray(nodes),
                                          tile_n=256, interpret=True)
    assign_ref = assign_points_to_nodes(jnp.asarray(pc), jnp.asarray(nodes))
    mins, idx = kernels.min_argmin(_t(pc), _t(nodes))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(assign_ref.ids))
    np.testing.assert_allclose(mins.numpy(), np.asarray(mins_ref), atol=1e-4,
                               rtol=1e-6)

    assign = tops.assign_points_to_nodes(_t(pc), _t(nodes))
    np.testing.assert_array_equal(assign.ids.numpy(), np.asarray(assign_ref.ids))
    np.testing.assert_array_equal(assign.counts.numpy(),
                                  np.asarray(assign_ref.counts))
    np.testing.assert_array_equal(assign.occupancy.numpy(),
                                  np.asarray(assign_ref.occupancy))


@pytest.mark.parametrize("k", [2, 3])
def test_assignment_k_nearest_is_k_major(k):
    """k > 1 (plain, stable sort): ids in k-major order, identical to
    usip_tpu's lax.top_k path, with the same counts and occupancy."""
    pc, nodes = _points_and_nodes(7)
    ref = assign_points_to_nodes(jnp.asarray(pc), jnp.asarray(nodes), k=k)
    out = tops.assign_points_to_nodes(_t(pc), _t(nodes), k=k)
    assert out.ids.shape == (B, k * N)
    np.testing.assert_array_equal(out.ids.numpy(), np.asarray(ref.ids))
    np.testing.assert_array_equal(out.counts.numpy(), np.asarray(ref.counts))
    np.testing.assert_array_equal(out.occupancy.numpy(),
                                  np.asarray(ref.occupancy))


def test_min_argmin_bf16_matches_bf16_assignment():
    """round_bf16 against assign_points_to_nodes(compute_dtype=bfloat16):
    ids differ on at most 0.1% of points, and where they differ the two
    nodes' fp32 distances lie within one bf16 step of each other."""
    pc, nodes = _points_and_nodes(4)
    ref = np.asarray(assign_points_to_nodes(
        jnp.asarray(pc), jnp.asarray(nodes), compute_dtype=jnp.bfloat16).ids)
    _, idx = kernels.min_argmin(_t(pc), _t(nodes), round_bf16=True)
    idx = idx.numpy()
    diff = idx != ref
    assert diff.mean() <= 1e-3, diff.mean()
    d = ((pc[:, :, None, :] - nodes[:, None, :, :]) ** 2).sum(-1)
    for b, i in zip(*np.nonzero(diff)):
        da, db = d[b, i, idx[b, i]], d[b, i, ref[b, i]]
        step = 2.0 ** (np.floor(np.log2(max(da, db))) - 7)
        assert abs(da - db) <= step, (da, db)


def test_knn_lowest_index_ties():
    """knn on a database holding every point twice: indices identical to
    usip_tpu's knn (lax.top_k), and of each duplicated pair the lower index
    comes first."""
    pc = _cloud(5, n=64, scale=1.0)
    db = np.concatenate([pc, pc], axis=1)
    k = 6
    d_ref, i_ref = knn(jnp.asarray(pc), jnp.asarray(db), k)
    d, i = tops.knn(_t(pc), _t(db), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), atol=1e-4)
    i = i.numpy()
    assert (i[..., 0::2] < 64).all() and (i[..., 1::2] == i[..., 0::2] + 64).all()
    g = tops.gather_points(_t(db), _t(i))
    np.testing.assert_array_equal(
        g.numpy(), np.asarray(gather_points(jnp.asarray(db), jnp.asarray(i))))


def test_segment_ops_match():
    """masked_scatter_max (empty node -> 0), segment_mean_count and
    scatter_back against usip_tpu.ops; the scatter-max and gather are exact,
    the means within 1e-5 (sums in another order)."""
    rng = np.random.default_rng(6)
    c, m = 8, 16
    f = rng.normal(size=(B, N, c)).astype(np.float32)
    ids = rng.integers(0, m - 3, size=(B, N)).astype(np.int32)  # 3 empty nodes
    x = rng.normal(size=(B, N, 3)).astype(np.float32)
    ref = np.asarray(masked_scatter_max(jnp.asarray(f), jnp.asarray(ids), m))
    out = tops.masked_scatter_max(_t(f), _t(ids).long(), m).numpy()
    np.testing.assert_array_equal(out, ref)
    assert (out[:, m - 3:] == 0).all()

    mean_ref, cnt_ref = segment_mean_count(jnp.asarray(x), jnp.asarray(ids), m)
    mean, cnt = tops.segment_mean_count(_t(x), _t(ids).long(), m)
    np.testing.assert_allclose(mean.numpy(), np.asarray(mean_ref), atol=1e-5)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_ref))

    back_ref = scatter_back(jnp.asarray(ref), jnp.asarray(ids))
    back = tops.scatter_back(_t(ref), _t(ids).long())
    np.testing.assert_array_equal(back.numpy(), np.asarray(back_ref))


@pytest.mark.parametrize("b,n,m,form", [
    # the serve assignment, the train step's assignment (bf16), its
    # keypoint -> cloud and its keypoint chamfer (fp32)
    (8, 16384, 512, (128, 4, 1, 512)), (16, 16384, 512, (128, 8, 1, 512)),
    (8, 512, 16384, (128, 1, 16, 1024)), (8, 512, 512, (128, 1, 8, 64)),
    # few candidates: no split; an odd candidate count rounds the tile up
    (2, 1000, 77, (128, 1, 1, 78)), (2, 5, 1, (128, 1, 1, 2)),
    # more candidates than one block's shared memory held before
    (1, 17, 20000, (128, 1, 16, 1250)), (64, 16384, 40000, (128, 8, 1, 2048)),
    # queries enough for one block an SM at 2 a thread, not at 4
    (4, 16384, 512, (128, 2, 1, 512))])
def test_min_argmin_form_choices(b, n, m, form):
    """The most queries a thread (at most 8) that gives each of 132 SMs a
    block; where none does, one a thread and the smallest cluster split
    that gives two blocks an SM (at most 16, each at least 64 candidates);
    tiles of at most 2048 candidates, even."""
    assert kernels.min_argmin_form(b, n, m) == kernels.MinArgminForm(*form)


def test_min_argmin_form_every_shape():
    """For shapes around the main paths': a form the C entry point takes,
    whose shared memory fits one block, that covers every candidate, and
    that gives every SM a block wherever a split of 8 can."""
    for b in (1, 2, 8, 16):
        for n in (1, 100, 512, 1025, 4096, 16384):
            for m in (1, 2, 63, 64, 512, 4097, 16384, 100000):
                f = kernels.min_argmin_form(b, n, m)
                assert f.threads % 32 == 0 and 32 <= f.threads <= 256
                assert f.points_per_thread in (1, 2, 4, 8)
                assert 1 <= f.split <= 16 and f.tile % 2 == 0
                assert f.tile >= min(2, m) and f.tile <= kernels._MA_TILE
                chunk = -(-m // f.split)
                assert f.tile >= min(chunk, kernels._MA_TILE)
                smem = 16 * f.tile + 8 * f.threads * f.points_per_thread
                assert smem <= kernels._MAX_SMEM
                blocks = b * -(-n // (f.threads * f.points_per_thread)) \
                    * f.split
                if b * -(-n // f.threads) * 16 >= 132 and m >= 16 * 64:
                    assert blocks >= 132, (b, n, m, f)


@pytest.mark.parametrize("m", [0, -1])
def test_min_argmin_form_limits(m):
    with pytest.raises(ValueError, match="candidates"):
        kernels.min_argmin_form(2, 100, m)


def test_min_argmin_many_candidates():
    """M = 20096 candidates (157 x 128, the Pallas kernel's lane rule), more
    than one block's shared memory held in the kernel's first form: the
    wrapper takes them (the plain version on the CPU), identical to the
    Pallas kernel's ids in interpret mode."""
    rng = np.random.default_rng(9)
    pc = rng.normal(size=(1, 128, 3)).astype(np.float32)
    cand = rng.normal(size=(1, 20096, 3)).astype(np.float32)
    _, idx_ref = min_argmin_pallas(jnp.asarray(pc), jnp.asarray(cand),
                                   tile_n=128, interpret=True)
    mins, idx = kernels.min_argmin(_t(pc), _t(cand))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))
    assert mins.shape == (1, 128) and bool((mins >= 0).all())
