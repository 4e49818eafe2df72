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
import math
from typing import NamedTuple, Sequence, Tuple

import torch

from usip_tpu_torch.ops.geometry import pairwise_sqdist

Tensor = torch.Tensor

LAUNCHES = {"fps": 0, "min_argmin": 0, "fusion_chain": 0, "smallest_k": 0,
            "scatter_max": 0}

# the largest dynamic shared memory one block may take on Hopper
_MAX_SMEM = 232448
# rows (nodes x neighbours) one fusion-chain block keeps in shared memory
_CHAIN_ROWS = 64
# contraction rows per packed weight slice (csrc/fusion_chain.cu kSlice)
_CHAIN_SLICE = 32
# layer widths the fusion-chain kernel takes (two warpgroups of wgmma N/2)
_CHAIN_WIDTHS = (32, 64, 128, 256, 512)
# the longest row the smallest-k kernel keeps in shared memory (fp32), with
# room left for the block's static reduction buffers
SMALLEST_K_MAX_N = (_MAX_SMEM - 1024) // 4
# static shared memory of the smallest-k block form, kept free of its row
_SMALLEST_K_STATIC = 256
# row length that the smallest-k contract pads to (the TPU's lane width):
# picks past the row's end, up to this padding, are clamped to N-1
_LANES = 128
# the longest cloud the FPS wrapper takes (16 bytes a point in one block's
# shared memory; the kernel needs 12)
FPS_MAX_S = _MAX_SMEM // 16
# most points one FPS thread keeps with their coordinates in registers, and
# the larger count of the form that reads coordinates from shared memory
_FPS_REG_POINTS = 8
_FPS_SMEM_POINTS = 16
# most blocks of one scatter-max cluster (the portable cluster size), and the
# fewest points each of them should take
_SCATTER_MAX_CLUSTER = 8
_SCATTER_MIN_CHUNK = 4096
# channel tiles of one scatter-max block, widest first (csrc/scatter_max.cu)
_SCATTER_TILES = (32, 16, 8)
# the H100's streaming multiprocessors: a launch should give each a block
_SMS = 132
# min/argmin: threads a block, queries a thread (most first), candidates
# staged at a time, fewest candidates a block of a split takes, most blocks
# of a split (a non-portable cluster size, which Hopper allows)
_MA_THREADS = 128
_MA_PPT = (8, 4, 2, 1)
_MA_TILE = 2048
_MA_MIN_CHUNK = 64
_MA_MAX_SPLIT = 16

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # points, first, out, B, S, k, threads, points a thread, registers,
    # stream
    "fps": ("usip_fps", [_P, _P, _P] + [_I] * 6 + [_P]),
    # points, nodes, mins, idx, B, N, M, round_bf16, threads, points a
    # thread, split, tile, stream
    "min_argmin": ("usip_min_argmin", [_P] * 4 + [_I] * 8 + [_P]),
    # x, packed weights, b1, b2, b3, b4, b5, out, BM, K, Cin, C, C2, stream
    "fusion_chain": ("usip_fusion_chain", [_P] * 8 + [_I] * 5 + [_P]),
    # scores, vals, idx, rows, N, k, stream
    "smallest_k": ("usip_smallest_k", [_P, _P, _P, _I, _I, _I, _P]),
    # f, ids, out, B, N, M, C, cluster, tile, vec, stream
    "scatter_max": ("usip_scatter_max", [_P, _P, _P] + [_I] * 7 + [_P]),
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


class FpsForm(NamedTuple):
    """The form of one ``csrc/fps.cu`` block: ``threads`` (a multiple of
    32, at most 1024) times ``points_per_thread`` covers the cloud;
    ``in_registers``: the points' coordinates sit in registers, else they
    are read from shared memory every step."""
    threads: int
    points_per_thread: int
    in_registers: bool


def fps_form(s: int) -> FpsForm:
    """The FPS kernel's form for clouds of ``s`` points: with their
    coordinates in registers, the fewest points a thread (a power of two,
    at most 8) that one warp covers, then the fewest warps that cover the
    cloud: 256 threads of 8 points at S=2048, 1024 at S=8192; past 8192
    points, 16 points a thread with the coordinates in shared memory (a
    thread's registers hold only their running minimum), 928 threads at the
    largest S. ``s`` above ``FPS_MAX_S`` raises."""
    if not 1 <= s <= FPS_MAX_S:
        raise ValueError(f"fps: S={s} must lie in [1, {FPS_MAX_S}] (one "
                         "block's shared memory)")
    if s <= 1024 * _FPS_REG_POINTS:
        ppt = 1
        while ppt < _FPS_REG_POINTS and 32 * ppt < s:
            ppt *= 2
        in_registers = True
    else:
        ppt, in_registers = _FPS_SMEM_POINTS, False
    return FpsForm(-(-s // (32 * ppt)) * 32, ppt, in_registers)


def fps(points: Tensor, first: Tensor, k: int) -> Tensor:
    """FPS picks ``(B, k)`` int32; kernel ``csrc/fps.cu`` for CUDA tensors.

    Counterpart of ``pallas_kernels.fps_pallas``: one block per cloud, each
    thread's points and running minimum in registers (``fps_form``), one
    barrier a step.
    """
    if points.device.type == "cpu":
        return fps_plain(points, first, k)
    dev = _cuda_device(points, "points")
    b, s = points.shape[0], points.shape[1]
    _check(points, "points", torch.float32, (b, s, 3), dev)
    _check(first, "first", torch.int32, (b,), dev)
    if not 1 <= k <= s:
        raise ValueError(f"fps: k={k} must lie in [1, S={s}]")
    form = fps_form(s)
    # the seed rows index shared memory: check them on the device (an
    # asynchronous assert, like PyTorch's own index checks), no host sync
    torch._assert_async(((first >= 0) & (first < s)).all())
    out = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b:
        _launch("fps", dev, points.data_ptr(), first.data_ptr(),
                out.data_ptr(), b, s, k, form.threads,
                form.points_per_thread, int(form.in_registers))
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


class MinArgminForm(NamedTuple):
    """The form of a ``csrc/min_argmin.cu`` launch: blocks of ``threads``
    threads, ``points_per_thread`` queries a thread; ``split`` blocks (a
    cluster) share one tile of queries, each taking 1/split of the
    candidates; ``tile`` candidates staged in shared memory at a time."""
    threads: int
    points_per_thread: int
    split: int
    tile: int


def min_argmin_form(b: int, n: int, m: int) -> MinArgminForm:
    """The min/argmin kernel's form for ``b`` clouds of ``n`` queries
    against ``m`` candidates: 128 threads; the most queries a thread (8, 4,
    2, 1) that still gives one block to each of the card's 132 SMs; where
    even one query a thread does not, one query a thread and the candidates
    split over a cluster of 2 to 16 blocks (each at least 64 candidates),
    the smallest split that gives two blocks an SM, or the largest. Tiles of
    at most 2048 candidates (32 KB). (8, 16384) x 512 -> 4 queries a
    thread, 256 blocks; (16, 16384) x 512 -> 8, 256 blocks; (8, 512) x
    16384 -> 1 query a thread, clusters of 16, 512 blocks; (8, 512) x 512
    -> clusters of 8 (64 candidates each), 256 blocks."""
    if m < 1:
        raise ValueError(f"min_argmin: M={m} candidates must be >= 1")
    threads = _MA_THREADS

    def blocks(ppt, split):
        return b * -(-n // (threads * ppt)) * split

    def tile(split):
        chunk = -(-m // split)
        return min(_MA_TILE, chunk + chunk % 2)

    for ppt in _MA_PPT:
        if blocks(ppt, 1) >= _SMS:
            return MinArgminForm(threads, ppt, 1, tile(1))
    # few queries: latency-bound, so one query a thread and as many warps as
    # the split gives, up to two blocks an SM
    split = 1
    while (split < _MA_MAX_SPLIT and blocks(1, split) < 2 * _SMS
           and -(-m // (2 * split)) >= _MA_MIN_CHUNK):
        split *= 2
    return MinArgminForm(threads, 1, split, tile(split))


def min_argmin(points: Tensor, nodes: Tensor, round_bf16: bool = False
               ) -> Tuple[Tensor, Tensor]:
    """Nearest candidate of every query, ``points (B, N, 3)`` against
    ``nodes (B, M, 3)``; kernel ``csrc/min_argmin.cu`` for CUDA tensors
    (counterpart of ``pallas_kernels.min_argmin_pallas``), which never
    builds the ``(B, N, M)`` matrix: queries in registers, candidates
    streamed through shared memory, split over a cluster when queries are
    few (``min_argmin_form``). Any M; the same results as
    ``min_argmin_plain`` for finite inputs."""
    if points.device.type == "cpu":
        return min_argmin_plain(points, nodes, round_bf16)
    dev = _cuda_device(points, "points")
    b, n, m = points.shape[0], points.shape[1], nodes.shape[1]
    _check(points, "points", torch.float32, (b, n, 3), dev)
    _check(nodes, "nodes", torch.float32, (b, m, 3), dev)
    form = min_argmin_form(b, n, m)
    mins = torch.empty((b, n), dtype=torch.float32, device=dev)
    idx = torch.empty((b, n), dtype=torch.int32, device=dev)
    if b and n:
        _launch("min_argmin", dev, points.data_ptr(), nodes.data_ptr(),
                mins.data_ptr(), idx.data_ptr(), b, n, m, int(round_bf16),
                *form)
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


class FusionChain(NamedTuple):
    """The fusion chain's folded weights, prepared once for the kernel.

    ``weights = (w1, w2, w3, w4m, w4h, w5)``, ``(Cin, Cout)`` kernels with BN
    folded, and ``biases = (b1, b2, b3, b4, b5)``, as
    ``fusion_chain_params`` returns them (the plain version's inputs);
    ``packed`` is every layer's bf16 weight in the kernel's layout
    (``_pack_layer``), one flat tensor on the weights' device: before0..2,
    then after0 as one ``(2C, C2)`` kernel (``w4m`` rows, then ``w4h``),
    then after1. ``cin`` is w1's contraction length before padding.
    """
    weights: Tuple[Tensor, ...]
    biases: Tuple[Tensor, ...]
    packed: Tensor
    cin: int


def _packed_shape(k: int, n: int) -> Tuple[int, int]:
    """A packed ``(K, N)`` layer's shape: K padded to whole slices, N to
    whole 8-column groups."""
    return -(-k // _CHAIN_SLICE) * _CHAIN_SLICE, -(-n // 8) * 8


def _pack_layer(w: Tensor) -> Tensor:
    """A ``(K, N)`` kernel -> bf16 slices in the layout ``csrc/fusion_chain.cu``
    reads with its B descriptor, flat.

    K is zero-padded to a multiple of 32 (one slice), N to a multiple of 8.
    Slice ``s`` holds contraction rows ``[32 s, 32 s + 32)``; inside it, the
    8 x 8 core matrix of k-group ``kg`` (rows ``8 kg ..``) and column group
    ``ng`` sits at element ``(kg * N / 8 + ng) * 64``, column-major in k:
    element ``(k, n)`` at ``+ (n % 8) * 8 + k % 8`` (no-swizzle K-major).
    """
    k, n = w.shape
    kp, np_ = _packed_shape(k, n)
    w = torch.nn.functional.pad(w.to(torch.bfloat16), (0, np_ - n, 0, kp - k))
    t = w.reshape(kp // _CHAIN_SLICE, _CHAIN_SLICE // 8, 8, np_ // 8, 8)
    return t.permute(0, 1, 3, 4, 2).reshape(-1)


def _unpack_layer(flat: Tensor, k: int, n: int) -> Tensor:
    """The inverse of ``_pack_layer``: ``(k, n)`` bf16."""
    kp, np_ = _packed_shape(k, n)
    t = flat.reshape(kp // _CHAIN_SLICE, _CHAIN_SLICE // 8, np_ // 8, 8, 8)
    return t.permute(0, 1, 4, 2, 3).reshape(kp, np_)[:k, :n]


def _chain_dims(cin: int, c: int, c2: int):
    """``(K, N)`` of the packed layers: before0..2, after0 (concat), after1."""
    return ((cin, c), (c, c), (c, c), (2 * c, c2), (c2, c2))


@torch.no_grad()
def prepare_chain(weights, biases) -> FusionChain:
    """Pack folded chain weights once for ``fusion_chain``: the re-layout
    the kernel needs is done here, not on every call. ``weights`` and
    ``biases`` as ``fusion_chain_params`` returns them (any float dtype;
    the kernel takes the weights as bf16 and the biases as fp32)."""
    w1, w2, w3, w4m, w4h, w5 = weights
    cin, c, c2 = w1.shape[0], w1.shape[1], w5.shape[1]
    names = ("w1", "w2", "w3", "w4m", "w4h", "w5")
    dims = ((cin, c), (c, c), (c, c), (c, c2), (c, c2), (c2, c2))
    for w, shape, name in zip(weights, dims, names):
        if tuple(w.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(w.shape)}, expected "
                             f"{shape}")
    for bb, n, name in zip(biases, (c, c, c, c2, c2),
                           ("b1", "b2", "b3", "b4", "b5")):
        if tuple(bb.shape) != (n,):
            raise ValueError(f"{name} has shape {tuple(bb.shape)}, expected "
                             f"{(n,)}")
    layers = (w1, w2, w3, torch.cat([w4m, w4h], 0), w5)
    packed = torch.cat([_pack_layer(w) for w in layers])
    return FusionChain(tuple(weights),
                       tuple(bb.float().contiguous() for bb in biases),
                       packed, cin)


def unpack_chain(chain: FusionChain) -> Tuple[Tensor, ...]:
    """The folded ``(Cin, Cout)`` bf16 weights ``(w1, w2, w3, w4m, w4h, w5)``
    read back from ``chain.packed``."""
    c, c2 = chain.biases[0].shape[0], chain.biases[4].shape[0]
    out, off = [], 0
    for k, n in _chain_dims(chain.cin, c, c2):
        size = math.prod(_packed_shape(k, n))
        out.append(_unpack_layer(chain.packed[off:off + size], k, n))
        off += size
    w1, w2, w3, w4, w5 = out
    return w1, w2, w3, w4[:c], w4[c:], w5


def fusion_chain_smem(k: int, cin: int, c: int, c2: int) -> int:
    """Shared memory of one ``csrc/fusion_chain.cu`` block (its
    ``layout_of``): the activation buffers P (``max(Cin padded to 32, C,
    C2)`` columns) and Q (``C``), 1,040 bytes per 8 columns; the tile's
    (64 / K, C2) fp32 output staging, inside Q where it fits; the weight
    ring, 4 stages of 32 x max(C, C2) bf16 where they fit, else 3; 16 bytes
    of mbarriers a stage."""
    kp1 = -(-cin // _CHAIN_SLICE) * _CHAIN_SLICE
    q = c // 8 * 1040
    staging = (_CHAIN_ROWS // k) * c2 * 4
    ring = max(kp1, c, c2) // 8 * 1040 + q + (0 if staging <= q else staging)
    stage = 64 * max(c, c2)
    stages = 4 if ring + 4 * (stage + 16) <= _MAX_SMEM else 3
    return ring + stages * (stage + 16)


def fusion_chain(grouped: Tensor, chain: FusionChain) -> Tensor:
    """Fused kNN-fusion chain; kernel ``csrc/fusion_chain.cu`` for CUDA
    tensors (counterpart of ``pallas_kernels.fused_fusion_chain``): wgmma
    tensor cores, the weights streamed through a shared-memory ring and
    shared by clusters of two blocks.

    ``chain`` is ``prepare_chain(*fusion_chain_params(layer))``, made once;
    this call only checks it. For CPU tensors, ``fusion_chain_plain`` on
    ``chain.weights``.
    """
    if grouped.device.type == "cpu":
        return fusion_chain_plain(grouped, chain.weights, chain.biases)
    dev = _cuda_device(grouped, "grouped")
    b, m, k, cin = grouped.shape
    c, c2 = chain.biases[0].shape[0], chain.biases[4].shape[0]
    _check(grouped, "grouped", torch.float32, (b, m, k, cin), dev)
    if cin != chain.cin:
        raise ValueError(f"grouped has {cin} channels, the chain takes "
                         f"{chain.cin}")
    size = sum(math.prod(_packed_shape(kk, n))
               for kk, n in _chain_dims(cin, c, c2))
    _check(chain.packed, "packed weights", torch.bfloat16, (size,), dev)
    for bb, n, name in zip(chain.biases, (c, c, c, c2, c2),
                           ("b1", "b2", "b3", "b4", "b5")):
        _check(bb, name, torch.float32, (n,), dev)
    if not 1 <= k <= _CHAIN_ROWS:
        raise ValueError(f"fusion_chain: K={k} must lie in [1, {_CHAIN_ROWS}]")
    if c not in _CHAIN_WIDTHS or c2 not in _CHAIN_WIDTHS:
        raise ValueError(f"fusion_chain: widths C={c}, C2={c2} must be "
                         f"multiples of 32 among {_CHAIN_WIDTHS}")
    if fusion_chain_smem(k, cin, c, c2) > _MAX_SMEM:
        raise ValueError(f"fusion_chain: K={k}, Cin={cin}, C={c}, C2={c2} "
                         "do not fit one block's shared memory")
    out = torch.empty((b, m, c2), dtype=torch.float32, device=dev)
    if b * m:
        _launch("fusion_chain", dev, grouped.data_ptr(),
                chain.packed.data_ptr(),
                *(bb.data_ptr() for bb in chain.biases), out.data_ptr(),
                b * m, k, cin, c, c2)
    return out


# ------------------------------------------------------------- smallest-k --

def _check_k(n: int, k: int) -> None:
    if n < 1:
        raise ValueError("smallest_k: rows must hold at least one entry")
    padded = -(-n // _LANES) * _LANES
    if not 1 <= k <= padded:
        raise ValueError(f"smallest_k: k={k} must lie in [1, {padded}] (N={n} "
                         f"rounded up to {_LANES})")


def smallest_k_plain(scores: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """The k smallest entries of the last axis: ``(values ascending fp32,
    indices int32)``, each ``(..., k)``.

    The contract of ``pallas_kernels.smallest_k_pallas``: ties go to the
    lowest index; non-finite entries (+inf, -inf, NaN) are absent and come
    after every finite one, in ascending index order, with value +inf; picks
    past the row's end (k > N, up to N rounded up to 128) get index N-1 and
    value +inf. A stable sort of the fp32 scores with the non-finite entries
    set to +inf, then the first k.
    """
    n = scores.shape[-1]
    _check_k(n, k)
    s = scores.float()
    s = torch.where(torch.isfinite(s), s, torch.inf)
    vals, idx = torch.sort(s, dim=-1, stable=True)
    vals, idx = vals[..., :k], idx[..., :k].int()
    if k > n:
        pad = tuple(vals.shape[:-1]) + (k - n,)
        vals = torch.cat([vals, vals.new_full(pad, torch.inf)], dim=-1)
        idx = torch.cat([idx, idx.new_full(pad, n - 1)], dim=-1)
    return vals, idx


def smallest_k_smem(n: int, k: int) -> int:
    """The least dynamic shared memory ``csrc/smallest_k.cu`` runs with for
    rows of ``n`` and ``k`` picks: 0 for the warp-per-row form (``n <=
    1024``, ``k <= 32``, the row in registers), else the row's keys (``n``
    rounded up to 4, 4 bytes each) and, after them, the larger of the
    512-byte histogram and the candidates (8 bytes each, their count
    rounded up to a power of two). The kernel adds a list of 2048 keys
    where it fits (``block_smem`` in the source)."""
    if n <= 1024 and k <= 32:
        return 0
    sort_len = 1
    while sort_len < min(k, n):
        sort_len *= 2
    return -(-n // 4) * 16 + max(512, 8 * sort_len)


def smallest_k(scores: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """Exact k smallest of each row of ``scores (..., N)`` fp32; kernel
    ``csrc/smallest_k.cu`` for CUDA tensors (counterpart of
    ``pallas_kernels.smallest_k_pallas``): a select by threshold on
    order-preserving keys, one warp per short row (registers) or one block
    per long row (shared memory). Same contract and results as
    ``smallest_k_plain``; rows longer than ``SMALLEST_K_MAX_N``, or whose
    keys and picks together do not fit one block, raise."""
    if scores.device.type == "cpu":
        return smallest_k_plain(scores, k)
    dev = _cuda_device(scores, "scores")
    if scores.dim() < 1:
        raise ValueError("smallest_k: scores must have a last axis")
    n = scores.shape[-1]
    _check(scores, "scores", torch.float32, scores.shape, dev)
    _check_k(n, k)
    if (n > SMALLEST_K_MAX_N or
            smallest_k_smem(n, k) + _SMALLEST_K_STATIC > _MAX_SMEM):
        raise ValueError(f"smallest_k: rows of N={n} with k={k} picks do not "
                         "fit one block's shared memory (N at most "
                         f"{SMALLEST_K_MAX_N})")
    shape = tuple(scores.shape[:-1]) + (k,)
    vals = torch.empty(shape, dtype=torch.float32, device=dev)
    idx = torch.empty(shape, dtype=torch.int32, device=dev)
    rows = scores.numel() // n
    if rows:
        _launch("smallest_k", dev, scores.data_ptr(), vals.data_ptr(),
                idx.data_ptr(), rows, n, k)
    return vals, idx


class SmallestK(torch.autograd.Function):
    """``smallest_k`` of any float dtype (taken as fp32), differentiable in
    the values: the backward scatters the value cotangent onto the selected
    positions and returns it in the primal dtype, the custom VJP of
    ``pallas_kernels.smallest_k_pallas``. The indices carry no gradient."""

    @staticmethod
    def forward(ctx, scores: Tensor, k: int):
        vals, idx = smallest_k(scores.float().contiguous(), k)
        ctx.save_for_backward(idx)
        ctx.shape, ctx.dtype = scores.shape, scores.dtype
        ctx.mark_non_differentiable(idx)
        return vals, idx

    @staticmethod
    def backward(ctx, g_vals, _g_idx):
        (idx,) = ctx.saved_tensors
        grad = torch.zeros(ctx.shape, dtype=torch.float32, device=idx.device)
        grad.scatter_add_(-1, idx.long(), g_vals.float())
        return grad.to(ctx.dtype), None


# ------------------------------------------------------------ scatter-max --

def scatter_max_plain(f: Tensor, ids: Tensor, m: int) -> Tensor:
    """Per-node channel max of point features: ``f (B, N, C)``, ``ids (B, N)``
    int64 in ``[0, m)`` -> ``(B, m, C)``; a node no point maps to is 0."""
    b, _, c = f.shape
    out = torch.zeros((b, m, c), dtype=f.dtype, device=f.device)
    return out.scatter_reduce(1, ids[..., None].expand(*ids.shape, c), f,
                              "amax", include_self=False)


class ScatterForm(NamedTuple):
    """The form of a ``csrc/scatter_max.cu`` launch: ``cluster`` blocks
    split the points of one (cloud, tile of ``tile`` channels)."""
    cluster: int
    tile: int


def scatter_max_form(n: int, m: int) -> ScatterForm:
    """The scatter-max kernel's form for ``n`` points a cloud onto ``m``
    nodes: the widest channel tile whose ``(m, tile)`` int32 accumulator
    fits one block's shared memory (32 channels up to 1816 nodes, 16, then
    8); as many blocks a cluster (a power of two, at most 8) as give each at
    least 4096 points (4 at N=16384, 1 below N=8192). An ``m`` that fits no
    tile raises."""
    if m < 1 or 4 * _SCATTER_TILES[-1] * m > _MAX_SMEM:
        raise ValueError(f"scatter_max: M={m} nodes must be >= 1 and fit one "
                         "block's shared memory")
    tile = next(t for t in _SCATTER_TILES if 4 * t * m <= _MAX_SMEM)
    ns = 1
    while ns < _SCATTER_MAX_CLUSTER and 2 * ns * _SCATTER_MIN_CHUNK <= n:
        ns *= 2
    return ScatterForm(ns, tile)


def scatter_max(f: Tensor, ids: Tensor, m: int) -> Tensor:
    """Masked scatter-max onto nodes; kernel ``csrc/scatter_max.cu`` for CUDA
    tensors (counterpart of ``scripts/bench_scatter_pallas.py
    scatter_max_pallas``): clusters of blocks per (cloud, channel tile), each
    block's node accumulator in shared memory, merged across the cluster
    (``scatter_max_form``). ``f`` fp32, ``ids`` int64; an id outside
    ``[0, m)`` fails a device assertion."""
    if f.device.type == "cpu":
        return scatter_max_plain(f, ids, m)
    dev = _cuda_device(f, "f")
    if f.dim() != 3:
        raise ValueError(f"f has shape {tuple(f.shape)}, expected (B, N, C)")
    b, n, c = f.shape
    _check(f, "f", torch.float32, (b, n, c), dev)
    _check(ids, "ids", torch.int64, (b, n), dev)
    form = scatter_max_form(n, m)
    out = torch.empty((b, m, c), dtype=torch.float32, device=dev)
    # float4 loads and stores where every row segment is 16-byte aligned
    vec = c % 4 == 0 and f.data_ptr() % 16 == 0
    if b and c:
        _launch("scatter_max", dev, f.data_ptr(), ids.data_ptr(),
                out.data_ptr(), b, n, m, c, form.cluster, form.tile, int(vec))
    return out
