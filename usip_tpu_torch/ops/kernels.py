"""The hand-written CUDA kernels of the serving path, with their plain versions.

Counterpart of ``usip_tpu/ops/pallas_kernels.py``. Each kernel has:

* a plain PyTorch version (``*_plain``), the reference that the CPU tests and
  ``chip_smoke.py`` hold the kernel against;
* a wrapper that runs the plain version for CPU tensors and, for CUDA
  tensors, checks device, dtype, shape and contiguity, launches the kernel on
  the current stream, or raises. There is no fallback from a CUDA tensor to
  the plain version;
* an integer launch count in ``LAUNCHES``, raised by one where the wrapper
  launches its kernel and nowhere else.

The kernels (``csrc/*.cu``) are compiled with nvcc at first use
(``usip_tpu_torch._build``) and bound with ctypes.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from usip_tpu_torch.ops.geometry import pairwise_sqdist

Tensor = torch.Tensor

LAUNCHES = {"fps": 0, "min_argmin": 0, "fusion_chain": 0}

# the largest dynamic shared memory one block may take on Hopper
_MAX_SMEM = 232448
# rows (nodes x neighbours) one fusion-chain block keeps in shared memory
_CHAIN_ROWS = 64

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # points, first, out, B, S, k, stream
    "fps": ("usip_fps", [_P, _P, _P, _I, _I, _I, _P]),
    # points, nodes, mins, idx, B, N, M, round_bf16, stream
    "min_argmin": ("usip_min_argmin", [_P, _P, _P, _P, _I, _I, _I, _I, _P]),
    # x, w1, b1, w2, b2, w3, b3, w4m, w4h, b4, w5, b5, out,
    # BM, K, Cin, C, C2, stream
    "fusion_chain": ("usip_fusion_chain", [_P] * 13 + [_I] * 5 + [_P]),
}
_FNS = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _kernel_fn(name: str):
    """The ctypes entry point of one kernel, built and loaded at first use."""
    if name not in _FNS:
        from usip_tpu_torch import _build
        symbol, argtypes = _SIGNATURES[name]
        fn = getattr(_build.load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return _FNS[name]


def _launch(name: str, device: torch.device, *args) -> None:
    """Launch on the current stream. Tensors the caller frees after this
    returns are safe: the caching allocator hands their memory only to work
    queued later on the same stream."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _kernel_fn(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def _check(t: Tensor, what: str, dtype: torch.dtype, shape: Sequence,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _cuda_device(t: Tensor, what: str) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"{what} is on {t.device}: the kernel takes CUDA "
                         "tensors, the plain version CPU tensors")
    return t.device


# --------------------------------------------------------------------- FPS --

def fps_plain(points: Tensor, first: Tensor, k: int) -> Tensor:
    """Farthest point sampling of ``points (B, S, 3)`` from the seed rows
    ``first (B,)`` -> ``(B, k)`` int32 picks, pick 0 == first.

    The recurrence of ``usip_tpu.ops.sampling._fps_single``: a running min of
    the squared distance to the newest pick, then the first-occurrence argmax
    (``torch.argmax`` returns the first maximal index).
    """
    p = points.float()
    b = p.shape[0]
    rows = torch.arange(b, device=p.device)

    def dist_to(i):
        dx, dy, dz = (p - p[rows, i][:, None, :]).unbind(-1)
        return dx * dx + dy * dy + dz * dz

    picks = torch.empty((b, k), dtype=torch.int64, device=p.device)
    picks[:, 0] = first
    dists = dist_to(first.long())
    for i in range(1, k):
        far = dists.argmax(dim=-1)
        picks[:, i] = far
        dists = torch.minimum(dists, dist_to(far))
    return picks.int()


def fps(points: Tensor, first: Tensor, k: int) -> Tensor:
    """FPS picks ``(B, k)`` int32; kernel ``csrc/fps.cu`` for CUDA tensors.

    Counterpart of ``pallas_kernels.fps_pallas``: one block per cloud with the
    cloud and its distance row in shared memory.
    """
    if points.device.type == "cpu":
        return fps_plain(points, first, k)
    dev = _cuda_device(points, "points")
    b, s = points.shape[0], points.shape[1]
    _check(points, "points", torch.float32, (b, s, 3), dev)
    _check(first, "first", torch.int32, (b,), dev)
    if not 1 <= k <= s:
        raise ValueError(f"fps: k={k} must lie in [1, S={s}]")
    if 16 * s > _MAX_SMEM:
        raise ValueError(f"fps: S={s} points do not fit one block's shared "
                         "memory")
    # the seed rows index shared memory: check them on the device (an
    # asynchronous assert, like PyTorch's own index checks), no host sync
    torch._assert_async(((first >= 0) & (first < s)).all())
    out = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b:
        _launch("fps", dev, points.data_ptr(), first.data_ptr(),
                out.data_ptr(), b, s, k)
    return out


# ---------------------------------------------------------- min / argmin --

def min_argmin_plain(points: Tensor, nodes: Tensor, round_bf16: bool = False
                     ) -> Tuple[Tensor, Tensor]:
    """Each point's nearest node: ``(min sqdist (B, N) fp32, index (B, N)
    int32)``.

    Distances are ``p_sq - 2 (p . n) + n_sq`` (optionally rounded to bf16),
    clamped at 0 before the first-occurrence argmin, as
    ``usip_tpu.ops.grouping.assign_points_to_nodes`` takes it.
    """
    d = pairwise_sqdist(points, nodes, round_bf16=round_bf16)
    idx = d.argmin(dim=-1)
    return d.gather(-1, idx[..., None])[..., 0], idx.int()


def min_argmin(points: Tensor, nodes: Tensor, round_bf16: bool = False
               ) -> Tuple[Tensor, Tensor]:
    """Nearest node of every point; kernel ``csrc/min_argmin.cu`` for CUDA
    tensors (counterpart of ``pallas_kernels.min_argmin_pallas``), which never
    builds the ``(B, N, M)`` matrix."""
    if points.device.type == "cpu":
        return min_argmin_plain(points, nodes, round_bf16)
    dev = _cuda_device(points, "points")
    b, n, m = points.shape[0], points.shape[1], nodes.shape[1]
    _check(points, "points", torch.float32, (b, n, 3), dev)
    _check(nodes, "nodes", torch.float32, (b, m, 3), dev)
    if m < 1 or 16 * m > _MAX_SMEM:
        raise ValueError(f"min_argmin: M={m} nodes must be >= 1 and fit one "
                         "block's shared memory")
    mins = torch.empty((b, n), dtype=torch.float32, device=dev)
    idx = torch.empty((b, n), dtype=torch.int32, device=dev)
    if b and n:
        _launch("min_argmin", dev, points.data_ptr(), nodes.data_ptr(),
                mins.data_ptr(), idx.data_ptr(), b, n, m, int(round_bf16))
    return mins, idx


# ----------------------------------------------------- fused fusion chain --

def fold_pointwise_params(layer, eps: float = 1e-5) -> Tuple[Tensor, Tensor]:
    """Fold a ``PointwiseLayer``'s eval-mode BatchNorm into its dense kernel
    and bias: ``(kernel (Cin, Cout), bias (Cout,))`` fp32.

    ``y = BN(x @ W + b) = x @ (W * s) + ((b - mean) * s + beta)`` with
    ``s = gamma * rsqrt(var + eps)``; layers without a norm pass through.
    """
    kern = layer.conv.kernel().float()
    bias = layer.conv.bias.float()
    if layer.norm is None:
        return kern, bias
    nrm = layer.norm
    s = nrm.weight.float() * torch.rsqrt(nrm.running_var.float() + eps)
    return kern * s[None, :], (bias - nrm.running_mean.float()) * s + nrm.bias.float()


@torch.no_grad()
def fusion_chain_params(knn_layer):
    """Folded weights of a ``KNNFusionOnNodes`` for ``fusion_chain``:
    before0..2 -> w1..3, after0 split at the concat boundary into
    ``(w4m, w4h)`` (rows acting on the per-node max, then on each neighbour,
    the concat order ``(h_max, h)``), after1 -> w5. Returns ``(ws, bs)``."""
    ws, bs = [], []
    for layer in knn_layer.layers_before:
        w, b = fold_pointwise_params(layer)
        ws.append(w)
        bs.append(b)
    after0, after1 = knn_layer.layers_after
    w4, b4 = fold_pointwise_params(after0)
    c = ws[-1].shape[1]
    ws.extend([w4[:c], w4[c:]])
    bs.append(b4)
    w5, b5 = fold_pointwise_params(after1)
    ws.append(w5)
    bs.append(b5)
    return tuple(ws), tuple(bs)


def _bf16(t: Tensor) -> Tensor:
    """Round to bf16 (nearest even) and compute on in fp32."""
    return t.to(torch.bfloat16).float()


def fusion_chain_plain(grouped: Tensor, weights, biases) -> Tensor:
    """Eval-mode kNN-fusion chain: ``grouped (B, M, K, Cin)`` fp32 ->
    ``(B, M, C2)`` fp32.

    bf16 operands, fp32 products and sums, rounded at the points of
    ``pallas_kernels._fusion_chain_kernel``: after each of the three
    ``before`` ReLUs, the per-node max (already bf16), and after the
    ``after0`` ReLU; the last ReLU and max stay fp32.
    """
    w1, w2, w3, w4m, w4h, w5 = (_bf16(w) for w in weights)
    b1, b2, b3, b4, b5 = (b.float() for b in biases)
    h = _bf16(grouped)
    for w, b in ((w1, b1), (w2, b2), (w3, b3)):
        h = _bf16(torch.relu(h @ w + b))
    h_max = h.amax(dim=-2)                                   # (B, M, C)
    side = h_max @ w4m + b4
    y = _bf16(torch.relu(h @ w4h + side[..., None, :]))
    y = torch.relu(y @ w5 + b5)
    return y.amax(dim=-2)


def _chain_weight(w: Tensor) -> Tensor:
    """A folded ``(Cin, Cout)`` kernel as the CUDA kernel takes it: bf16,
    transposed to ``(Cout, Kp)`` (the reference's conv layout), the
    contraction zero-padded to a multiple of 16."""
    wt = w.t().to(torch.bfloat16)
    pad = (-wt.shape[1]) % 16
    return torch.nn.functional.pad(wt, (0, pad)).contiguous()


def fusion_chain(grouped: Tensor, weights, biases) -> Tensor:
    """Fused kNN-fusion chain; kernel ``csrc/fusion_chain.cu`` for CUDA
    tensors (counterpart of ``pallas_kernels.fused_fusion_chain``).

    ``weights = (w1, w2, w3, w4m, w4h, w5)``, ``(Cin, Cout)`` kernels with
    BN folded (any float dtype, taken as bf16), ``biases = (b1, b2, b3, b4,
    b5)`` (taken as fp32).
    """
    if grouped.device.type == "cpu":
        return fusion_chain_plain(grouped, weights, biases)
    dev = _cuda_device(grouped, "grouped")
    b, m, k, cin = grouped.shape
    c, c2 = weights[0].shape[1], weights[5].shape[1]
    _check(grouped, "grouped", torch.float32, (b, m, k, cin), dev)
    names = ("w1", "w2", "w3", "w4m", "w4h", "w5")
    dims = ((cin, c), (c, c), (c, c), (c, c2), (c, c2), (c2, c2))
    for w, shape, name in zip(weights, dims, names):
        if tuple(w.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(w.shape)}, expected "
                             f"{shape}")
    ws = [_chain_weight(w) for w in weights]
    bs = [bb.float().contiguous() for bb in biases]
    for w, name in zip(ws, names):
        _check(w, name, torch.bfloat16, w.shape, dev)
    for bb, n, name in zip(bs, (c, c, c, c2, c2), ("b1", "b2", "b3", "b4", "b5")):
        _check(bb, name, torch.float32, (n,), dev)
    if not 1 <= k <= _CHAIN_ROWS:
        raise ValueError(f"fusion_chain: K={k} must lie in [1, {_CHAIN_ROWS}]")
    if c % 32 or c2 % 32:
        raise ValueError(f"fusion_chain: widths C={c}, C2={c2} must be "
                         "multiples of 32")
    out = torch.empty((b, m, c2), dtype=torch.float32, device=dev)
    if b * m:
        _launch("fusion_chain", dev, grouped.data_ptr(),
                ws[0].data_ptr(), bs[0].data_ptr(), ws[1].data_ptr(),
                bs[1].data_ptr(), ws[2].data_ptr(), bs[2].data_ptr(),
                ws[3].data_ptr(), ws[4].data_ptr(), bs[3].data_ptr(),
                ws[5].data_ptr(), bs[4].data_ptr(), out.data_ptr(),
                b * m, k, cin, c, c2)
    return out
