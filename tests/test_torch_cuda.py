"""The CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and nvcc (a CUDA kernel has no CPU build), so
they carry the ``cuda`` marker and skip elsewhere. On a GPU host, where jax
is absent, run them without the suite's conftest (which sets jax up):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

They cover shapes off the serving path: odd and ragged sizes, small widths,
K that does not divide the 64-row tile.
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
                                           (9, 64, 16, 32, 32)])
def test_fusion_chain_kernel_matches_plain(dev, bm, k, cin, c, c2):
    """Within 1e-2 * max|plain| (max) and 1e-3 * max|plain| (median): bf16
    operands, fp32 sums in another order."""
    rng = np.random.default_rng(bm + k)
    x = _rand(rng, (1, bm, k, cin), dev)
    dims = [(cin, c), (c, c), (c, c), (c, c2), (c, c2), (c2, c2)]
    ws = [_rand(rng, d, dev, (2.0 / d[0]) ** 0.5) for d in dims]
    bs = [_rand(rng, (d[1],), dev, 0.1) for d in dims[:3] + dims[4:]]
    got = kernels.fusion_chain(x, ws, bs)
    ref = kernels.fusion_chain_plain(x, ws, bs)
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    err = (got - ref).abs()
    assert scale > 0
    assert float(err.max()) <= 1e-2 * scale
    assert float(err.median()) <= 1e-3 * scale


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
        kernels.fusion_chain(x, [torch.zeros(d, device=dev) for d in dims],
                             [torch.zeros(d[1], device=dev)
                              for d in dims[:3] + dims[4:]])
