"""The CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and nvcc (a CUDA kernel has no CPU build), so
they carry the ``cuda`` marker and skip elsewhere. On a GPU host, where jax
is absent, run them without the suite's conftest (which sets jax up):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

They cover shapes off the serving path: odd and ragged sizes, small widths,
K that does not divide the 64-row tile, rows that are not a multiple of 32,
channel counts that are not a multiple of the scatter tile.
"""

import numpy as np
import pytest
import torch

from usip_tpu_torch.ops import kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU build")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, shape, dev, scale=1.0):
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(
        np.float32)).to(dev)


@pytest.mark.parametrize("s,k,dup", [(2048, 512, False), (1000, 77, False),
                                     (1000, 1, False), (600, 300, True)])
def test_fps_kernel_matches_plain(dev, s, k, dup):
    rng = np.random.default_rng(s + k)
    pts = _rand(rng, (3, s, 3), dev, 20.0)
    if dup:
        pts = torch.cat([pts[:, : s // 2], pts[:, : s // 2]], 1).contiguous()
    first = torch.from_numpy(rng.integers(0, s, 3).astype(np.int32)).to(dev)
    got = kernels.fps(pts, first, k)
    torch.cuda.synchronize()
    assert torch.equal(got, kernels.fps_plain(pts, first, k))


def _fps_case(dev, b, s, k, seed, pts=None):
    rng = np.random.default_rng(seed)
    if pts is None:
        pts = _rand(rng, (b, s, 3), dev, 20.0)
    first = torch.from_numpy(rng.integers(0, s, b).astype(np.int32)).to(dev)
    got = kernels.fps(pts, first, k)
    torch.cuda.synchronize()
    ref = kernels.fps_plain(pts, first, k)
    assert torch.equal(got, ref)
    return got


# each boundary of the kernel's forms (kernels.fps_form: points a thread x
# threads, +-1), and the largest cloud the wrapper takes
@pytest.mark.parametrize("s", [32, 33, 64, 65, 128, 129, 256, 257, 512,
                               513, 1024, 1025, 2047, 2048, 2049, 4096, 4097,
                               8192, 8193, kernels.FPS_MAX_S])
def test_fps_kernel_form_boundaries(dev, s):
    _fps_case(dev, 2, s, min(s, 300), s)


@pytest.mark.parametrize("s", [1, 33, 1000, 8193])
def test_fps_kernel_k_equals_s(dev, s):
    """Every point picked: the last picks run over distances of 0."""
    got = _fps_case(dev, 2, s, s, s + 1)
    assert torch.equal(got.sort(-1).values,
                       torch.arange(s, dtype=torch.int32,
                                    device=dev).expand(2, s))


def test_fps_kernel_all_points_equal(dev):
    """Every distance 0: each pick after the seed is the lowest index."""
    pts = torch.full((3, 2048, 3), 3.5, device=dev)
    got = _fps_case(dev, 3, 2048, 512, 7, pts)
    assert bool((got[:, 1:] == 0).all())


@pytest.mark.parametrize("b", [1, 64])
def test_fps_kernel_batch(dev, b):
    _fps_case(dev, b, 2048, 512, b)


@pytest.mark.parametrize("n,m", [(16384, 512), (1000, 77), (5, 1)])
@pytest.mark.parametrize("round_bf16", [False, True])
def test_min_argmin_kernel_matches_plain(dev, n, m, round_bf16):
    rng = np.random.default_rng(n + m)
    pts = _rand(rng, (2, n, 3), dev, 10.0)
    nodes = pts[:, :m].contiguous() if m <= n else _rand(rng, (2, m, 3), dev)
    mins, idx = kernels.min_argmin(pts, nodes, round_bf16)
    rmins, ridx = kernels.min_argmin_plain(pts, nodes, round_bf16)
    torch.cuda.synchronize()
    assert torch.equal(idx, ridx)
    assert torch.equal(mins, rmins)


@pytest.mark.parametrize("bm,k,cin,c,c2", [(4096, 16, 131, 256, 512),
                                           (37, 4, 19, 32, 64),
                                           (50, 3, 35, 64, 32),
                                           (9, 64, 16, 32, 32),
                                           (1000, 16, 67, 128, 256),
                                           (3, 1, 40, 64, 128),
                                           (513, 32, 131, 256, 512)])
def test_fusion_chain_kernel_matches_plain(dev, bm, k, cin, c, c2):
    """Within 1e-2 * max|plain| (max) and 1e-3 * max|plain| (median): bf16
    operands, fp32 sums in another order. The kernel takes the weights
    packed once by ``prepare_chain``; an odd tile count leaves one block of
    a cluster pair without nodes."""
    rng = np.random.default_rng(bm + k)
    x = _rand(rng, (1, bm, k, cin), dev)
    dims = [(cin, c), (c, c), (c, c), (c, c2), (c, c2), (c2, c2)]
    ws = [_rand(rng, d, dev, (2.0 / d[0]) ** 0.5) for d in dims]
    bs = [_rand(rng, (d[1],), dev, 0.1) for d in dims[:3] + dims[4:]]
    chain = kernels.prepare_chain(ws, bs)
    got = kernels.fusion_chain(x, chain)
    ref = kernels.fusion_chain_plain(x, ws, bs)
    # the packed layout on the card reads back as the bf16 weights
    for w, u in zip(ws, kernels.unpack_chain(chain)):
        assert torch.equal(u, w.to(torch.bfloat16))
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    err = (got - ref).abs()
    assert scale > 0
    assert float(err.max()) <= 1e-2 * scale
    assert float(err.median()) <= 1e-3 * scale


@pytest.mark.parametrize("rows,n", [(37, 1000), (5, 16384), (300, 7),
                                    (3, 50000)])
@pytest.mark.parametrize("k", [1, 7, 64, 128])
def test_smallest_k_kernel_matches_plain(dev, rows, n, k):
    """Values and indices identical to the plain version on rows with
    integer ties, +inf runs, NaN and -inf, including k > N."""
    rng = np.random.default_rng(rows * n + k)
    s = rng.integers(-20, 20, size=(rows, n)).astype(np.float32)
    kinds = rng.integers(0, 16, size=s.shape)
    s[kinds == 0] = np.inf
    s[kinds == 1] = np.nan
    s[kinds == 2] = -np.inf
    s[0] = np.inf
    scores = torch.from_numpy(s).to(dev)
    vals, idx = kernels.smallest_k(scores, k)
    rvals, ridx = kernels.smallest_k_plain(scores, k)
    torch.cuda.synchronize()
    assert torch.equal(idx, ridx)
    assert torch.equal(vals, rvals)


def _adversarial_rows(rng, rows, n, kind):
    """Rows that stress the select-by-threshold kernel's order: +0.0 and
    -0.0 ties among few distinct values; rows of all +inf (every pick a tie
    at the threshold); NaN, -inf and +inf mixed with finite values."""
    if kind == "signed_zeros":
        s = rng.choice(np.array([0.0, -0.0, 1.0, -1.0], np.float32),
                       size=(rows, n))
    elif kind == "inf_rows":
        s = rng.normal(size=(rows, n)).astype(np.float32)
        s[::2] = np.inf
        s[1::4, : n // 3] = np.inf
    else:
        s = rng.normal(size=(rows, n)).astype(np.float32)
        kinds = rng.integers(0, 4, size=s.shape)
        s[kinds == 0] = np.nan
        s[kinds == 1] = -np.inf
        s[kinds == 2] = np.inf
    return s


@pytest.mark.parametrize("kind", ["signed_zeros", "inf_rows", "nan_mix"])
@pytest.mark.parametrize("n", [7, 512, 1000, 16384])
@pytest.mark.parametrize("k", [1, 16, 64, 128])
def test_smallest_k_kernel_adversarial(dev, kind, n, k):
    """Identical to the plain version, values (-0.0 kept as -0.0) and
    indices, on ties at +-0, rows of +inf, NaN/-inf mixes; k > N pads. The
    plain version runs on the CPU here: its stable sort is the contract,
    whatever the card's sort makes of -0.0."""
    rng = np.random.default_rng(n * k + len(kind))
    s = torch.from_numpy(_adversarial_rows(rng, 6, n, kind))
    vals, idx = kernels.smallest_k(s.to(dev), k)
    torch.cuda.synchronize()
    vals, idx = vals.cpu(), idx.cpu()
    rvals, ridx = kernels.smallest_k_plain(s, k)
    assert torch.equal(idx, ridx)
    assert torch.equal(vals, rvals)
    assert torch.equal(torch.signbit(vals), torch.signbit(rvals))


@pytest.mark.parametrize("k", [16, 32, 33])
def test_smallest_k_kernel_many_short_rows(dev, k):
    """4096 rows of N=512: the warp-per-row form (k <= 32) and the block
    form (k = 33), on integer distances full of ties."""
    rng = np.random.default_rng(k)
    s = rng.integers(0, 30, size=(8, 512, 512)).astype(np.float32)
    scores = torch.from_numpy(s).to(dev)
    vals, idx = kernels.smallest_k(scores, k)
    rvals, ridx = kernels.smallest_k_plain(scores, k)
    torch.cuda.synchronize()
    assert torch.equal(idx, ridx)
    assert torch.equal(vals, rvals)


def test_smallest_k_grad_on_card(dev):
    """The autograd wrapper's backward on the card equals the CPU one."""
    from usip_tpu_torch.ops.topk import smallest_k

    s = torch.from_numpy(np.random.default_rng(0).normal(
        size=(6, 777)).astype(np.float32))
    g = torch.from_numpy(np.random.default_rng(1).normal(
        size=(6, 9)).astype(np.float32))
    grads = []
    for d in (dev, torch.device("cpu")):
        x = s.to(d).requires_grad_(True)
        smallest_k(x, 9)[0].backward(g.to(d))
        grads.append(x.grad.cpu())
    assert torch.equal(*grads)


@pytest.mark.parametrize("b,n,m,c", [(8, 16384, 512, 64), (2, 1000, 77, 13),
                                     (3, 333, 5, 40), (1, 17, 600, 3)])
def test_scatter_max_kernel_matches_plain(dev, b, n, m, c):
    """Equal to scatter_reduce('amax') with empty nodes 0, including nodes no
    point maps to and negative features."""
    rng = np.random.default_rng(n + m + c)
    f = _rand(rng, (b, n, c), dev, 3.0)
    ids = torch.from_numpy(rng.integers(0, max(1, m - 3), size=(b, n))).to(dev)
    got = kernels.scatter_max(f, ids, m)
    ref = kernels.scatter_max_plain(f, ids, m)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def _scatter_case(dev, f, ids, m):
    got = kernels.scatter_max(f, ids, m)
    torch.cuda.synchronize()
    ref = kernels.scatter_max_plain(f, ids, m)
    assert torch.equal(got, ref)
    return got


@pytest.mark.parametrize("m,node", [(1, 0), (512, 300)])
def test_scatter_max_kernel_one_node(dev, m, node):
    """Every point on one node (of 1, and of 512): each block of the cluster
    updates the same row, the others stay 0."""
    rng = np.random.default_rng(m)
    f = _rand(rng, (2, 16384, 64), dev, 3.0)
    ids = torch.full((2, 16384), node, dtype=torch.int64, device=dev)
    got = _scatter_case(dev, f, ids, m)
    assert torch.equal(got[:, node], f.amax(1))
    assert int((got != 0).any(-1).sum()) == 2


@pytest.mark.parametrize("kind", ["signed_zeros", "all_negative"])
def test_scatter_max_kernel_signs(dev, kind):
    """+0.0 and -0.0 only, or every feature below 0: the ordered-int
    encoding keeps the order of negative floats, and a node's max stays
    negative while an empty node is 0."""
    rng = np.random.default_rng(len(kind))
    if kind == "signed_zeros":
        f = rng.choice(np.array([0.0, -0.0], np.float32), (2, 16384, 64))
    else:
        f = -np.abs(rng.normal(size=(2, 16384, 64))).astype(np.float32) - 1
    ids = torch.from_numpy(rng.integers(0, 500, size=(2, 16384))).to(dev)
    got = _scatter_case(dev, torch.from_numpy(f).to(dev), ids, 512)
    if kind == "all_negative":
        assert bool((got[:, :500] < 0).all() and (got[:, 500:] == 0).all())


@pytest.mark.parametrize("n,m,c", [(16384, 512, 13), (16384, 512, 40),
                                   (16384 + 37, 512, 64), (40003, 512, 64),
                                   (9000, 512, 128), (3000, 2000, 24),
                                   (2100, 5000, 9)])
def test_scatter_max_kernel_forms(dev, n, m, c):
    """Ragged channel tiles (C = 13, 40, 9), N not a multiple of the
    cluster's chunk (N = 16421 over 4 blocks, 40003 over 8, 9000 over 2),
    the 16- and 8-channel tiles of many nodes (kernels.scatter_max_form)."""
    rng = np.random.default_rng(n + m + c)
    f = _rand(rng, (3, n, c), dev, 3.0)
    ids = torch.from_numpy(rng.integers(0, m, size=(3, n))).to(dev)
    _scatter_case(dev, f, ids, m)


def test_scatter_max_kernel_unaligned_features(dev):
    """C % 4 == 0 but the features 4 bytes past a 16-byte boundary: scalar
    loads instead of float4."""
    rng = np.random.default_rng(5)
    flat = _rand(rng, (2 * 4096 * 32 + 1,), dev)
    f = flat[1:].view(2, 4096, 32)
    assert f.is_contiguous() and f.data_ptr() % 16 != 0
    ids = torch.from_numpy(rng.integers(0, 512, size=(2, 4096))).to(dev)
    _scatter_case(dev, f, ids, 512)


def test_wrappers_reject_bad_cuda_inputs(dev):
    pts = torch.zeros((2, 64, 3), device=dev)
    first = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        kernels.fps(pts.double(), first, 8)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.fps(pts.transpose(0, 1).contiguous().transpose(0, 1), first, 8)
    with pytest.raises(ValueError):
        kernels.fps(pts, first, 65)
    with pytest.raises(TypeError):
        kernels.min_argmin(pts, pts.half())
    with pytest.raises(ValueError, match="multiples of 32"):
        x = torch.zeros((1, 2, 4, 5), device=dev)
        dims = [(5, 16), (16, 16), (16, 16), (16, 32), (16, 32), (32, 32)]
        kernels.fusion_chain(x, kernels.prepare_chain(
            [torch.zeros(d, device=dev) for d in dims],
            [torch.zeros(d[1], device=dev) for d in dims[:3] + dims[4:]]))
    scores = torch.zeros((4, 256), device=dev)
    with pytest.raises(TypeError):
        kernels.smallest_k(scores.double(), 8)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.smallest_k(scores.t(), 2)
    with pytest.raises(ValueError, match="shared memory"):
        kernels.smallest_k(torch.zeros((1, kernels.SMALLEST_K_MAX_N + 1),
                                       device=dev), 8)
    f = torch.zeros((2, 64, 8), device=dev)
    ids = torch.zeros((2, 64), dtype=torch.int64, device=dev)
    with pytest.raises(TypeError):
        kernels.scatter_max(f.half(), ids, 4)
    with pytest.raises(TypeError):
        kernels.scatter_max(f, ids.int(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.scatter_max(f.transpose(0, 1).contiguous().transpose(0, 1),
                            ids, 4)
