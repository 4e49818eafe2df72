"""The port's selection and scatter kernels' plain versions against usip_tpu.

``smallest_k`` (K4's plain version, a stable sort) against
``smallest_k_pallas`` in interpret mode and ``ops.topk.smallest_k`` direct
(``lax.top_k``); ``scatter_max`` (K5's plain version) against
``jax.ops.segment_max`` with empty nodes set to 0, the semantics of
``scripts/bench_scatter_pallas.py scatter_max_xla``. Inputs come from a numpy
seed; on the CPU each wrapper runs its plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from usip_tpu.ops.pallas_kernels import smallest_k_pallas
from usip_tpu.ops.topk import smallest_k as jax_smallest_k
from usip_tpu_torch.ops import kernels
from usip_tpu_torch.ops.topk import smallest_k

torch.set_num_threads(1)


def _ball_rows(rng, b=2, m=24, n=640):
    """Ball-query-like rows: integer priorities with many ties, +inf outside
    the ball, an empty row and a row with fewer than k finite entries."""
    prio = rng.integers(0, 80, size=(b, 1, n)).astype(np.float32)
    in_ball = rng.uniform(size=(b, m, n)) < 0.25
    s = np.where(in_ball, np.broadcast_to(prio, (b, m, n)), np.inf)
    s[0, 0] = np.inf
    s[0, 1] = np.inf
    s[0, 1, :3] = [5.0, 1.0, 5.0]
    return s.astype(np.float32)


def _knn_rows(rng, b=2, m=16, n=300):
    """Squared distances of a cloud whose every point appears twice."""
    half = rng.normal(size=(b, n // 2, 3))
    pts = np.concatenate([half, half], axis=1)
    q = rng.normal(size=(b, m, 3))
    return ((q[:, :, None] - pts[:, None]) ** 2).sum(-1).astype(np.float32)


CASES = {
    # (rows, k); every N here is ragged against the 128-lane padding
    "ball_ties_and_inf": (lambda rng: _ball_rows(rng), 16),
    "knn_duplicates": (lambda rng: _knn_rows(rng), 7),
    "integer_ties": (lambda rng: rng.integers(0, 5, size=(3, 5, 333)).astype(
        np.float32), 64),
    "ragged_normal": (lambda rng: rng.normal(size=(2, 24, 500)).astype(
        np.float32), 16),
    "k_equals_n": (lambda rng: rng.normal(size=(4, 96)).astype(np.float32),
                   96),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_smallest_k_plain_matches_pallas_and_direct(case):
    """Values and indices bit-identical to smallest_k_pallas (interpret) and
    to lax.top_k negated, tie order included."""
    make, k = CASES[case]
    s = make(np.random.default_rng(len(case)))
    vals, idx = smallest_k(torch.from_numpy(s), k)
    assert vals.dtype == torch.float32 and idx.dtype == torch.int32
    pv, pi = smallest_k_pallas(jnp.asarray(s), k, interpret=True)
    dv, di = jax_smallest_k(jnp.asarray(s), k, method="direct")
    for rv, ri in ((pv, pi), (dv, di)):
        np.testing.assert_array_equal(vals.numpy(), np.asarray(rv))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))


@pytest.mark.parametrize("n,k", [(100, 101), (100, 128), (5, 128), (200, 256)])
def test_smallest_k_past_row_end_clamps(n, k):
    """k > N (up to N rounded up to 128): the picks past the row's end are
    index N-1 with value +inf, like smallest_k_pallas's clamped lane
    padding; the first N are the whole row in order."""
    rng = np.random.default_rng(n + k)
    s = rng.integers(0, 9, size=(3, n)).astype(np.float32)
    s[0, ::3] = np.inf
    vals, idx = smallest_k(torch.from_numpy(s), k)
    pv, pi = smallest_k_pallas(jnp.asarray(s), k, interpret=True)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(pv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(pi))
    assert (idx.numpy()[:, n:] == n - 1).all()
    assert np.isinf(vals.numpy()[:, n:]).all()


def test_smallest_k_nonfinite_entries_are_absent():
    """NaN and -inf sort with the +infs, after every finite entry, in index
    order, and come back as +inf: smallest_k_pallas's contract (which
    diverges from lax.top_k, where -inf comes first). With the non-finite
    entries set to +inf beforehand, lax.top_k agrees."""
    rng = np.random.default_rng(11)
    s = rng.integers(-4, 4, size=(2, 12, 257)).astype(np.float32)
    kinds = rng.integers(0, 8, size=s.shape)
    s[kinds == 0] = np.nan
    s[kinds == 1] = -np.inf
    s[kinds == 2] = np.inf
    s[1, 3] = np.nan                      # a row with no finite entry
    k = 128
    vals, idx = smallest_k(torch.from_numpy(s), k)
    pv, pi = smallest_k_pallas(jnp.asarray(s), k, interpret=True)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(pv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(pi))
    masked = np.where(np.isfinite(s), s, np.inf).astype(np.float32)
    dv, di = jax_smallest_k(jnp.asarray(masked), k, method="direct")
    np.testing.assert_array_equal(vals.numpy(), np.asarray(dv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(di))
    assert not np.isnan(vals.numpy()).any()
    assert (~np.isfinite(vals.numpy()) == np.isinf(vals.numpy())).all()
    assert (vals.numpy()[1, 3] == np.inf).all()
    np.testing.assert_array_equal(idx.numpy()[1, 3], np.arange(k))


@pytest.mark.parametrize("n,k", [(384, 8), (100, 110)])
def test_smallest_k_grad_matches_jax_vjp(n, k):
    """The value cotangent scatters onto the selected positions (clamped
    picks past the row's end add up at N-1), like smallest_k_pallas's VJP."""
    rng = np.random.default_rng(n)
    s = rng.normal(size=(5, n)).astype(np.float32)
    g = rng.normal(size=(5, k)).astype(np.float32)
    _, vjp = jax.vjp(lambda x: smallest_k_pallas(x, k, interpret=True)[0],
                     jnp.asarray(s))
    (ref,) = vjp(jnp.asarray(g))
    x = torch.from_numpy(s).requires_grad_(True)
    vals, idx = smallest_k(x, k)
    assert not idx.requires_grad
    vals.backward(torch.from_numpy(g))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


def test_smallest_k_bf16_grad_in_primal_dtype():
    """A bf16 input is selected as fp32 and its gradient comes back in bf16,
    one unit per selected position."""
    s = torch.from_numpy(np.random.default_rng(3).normal(
        size=(4, 256)).astype(np.float32)).bfloat16().requires_grad_(True)
    vals, _ = smallest_k(s, 8)
    assert vals.dtype == torch.float32
    vals.sum().backward()
    assert s.grad.dtype == torch.bfloat16
    assert float(s.grad.float().sum()) == 4 * 8


def test_smallest_k_rejects_bad_k():
    s = torch.zeros((2, 100))
    for k in (0, 129):
        with pytest.raises(ValueError, match="must lie in"):
            kernels.smallest_k(s, k)
    with pytest.raises(ValueError, match="at least one entry"):
        kernels.smallest_k(torch.zeros((2, 0)), 1)


@pytest.mark.parametrize("c", [8, 13, 64])
def test_scatter_max_plain_matches_segment_max(c):
    """Per-node channel max equal to jax.ops.segment_max with empty nodes set
    to 0; ids leave the last nodes empty."""
    rng = np.random.default_rng(c)
    b, n, m = 2, 700, 40
    f = rng.normal(size=(b, n, c)).astype(np.float32)
    ids = rng.integers(0, m - 5, size=(b, n))

    def one(fb, ib):
        seg = jax.ops.segment_max(fb, ib, num_segments=m)
        return jnp.where(jnp.isneginf(seg), 0.0, seg)

    ref = np.asarray(jax.vmap(one)(jnp.asarray(f), jnp.asarray(ids)))
    out = kernels.scatter_max(torch.from_numpy(f), torch.from_numpy(ids), m)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (out.numpy()[:, m - 5:] == 0).all()


def test_new_wrappers_refuse_non_cuda_devices():
    """smallest_k and scatter_max run their plain version only for CPU
    tensors; another device that is not CUDA is refused."""
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.smallest_k(torch.empty((2, 64), device="meta"), 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.scatter_max(torch.empty((1, 8, 4), device="meta"),
                            torch.empty((1, 8), dtype=torch.int64,
                                        device="meta"), 4)
