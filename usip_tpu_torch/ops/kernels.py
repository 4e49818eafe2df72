"""The hand-written CUDA kernels of the port, with their plain versions.

Counterpart of ``usip_tpu/ops/pallas_kernels.py`` (five kernels), plus
train-mode BatchNorm (``csrc/batch_norm.cu``, five stages as ops
``usip::batch_norm_*``, which no TPU kernel had). Each kernel has:

* a plain PyTorch version (``*_plain``), the reference that the CPU tests and
  ``chip_smoke.py`` hold the kernel against;
* a ``torch.library`` custom op (``usip::fps``, ``usip::min_argmin``,
  ``usip::fusion_chain``, ``usip::smallest_k``, ``usip::scatter_max``) with
  a CPU kernel (the plain version), a CUDA kernel (checks device, dtype,
  shape and contiguity, launches the CUDA kernel on the current stream, or
  raises) and a fake kernel (the output shapes and dtypes, for
  ``torch.export`` and other tracers). There is no fallback from a CUDA
  tensor to the plain version;
* a public wrapper that calls the op (a tensor on any device but the CPU
  and CUDA is refused);
* an integer launch count in ``LAUNCHES``, raised by one where the CUDA
  kernel of the op launches and nowhere else.

The BatchNorm stages' ops have a CUDA kernel and a fake kernel only: on the
CPU train mode is ``nn/layers.py batch_norm_plain``, and the stages' plain
versions are the references of the kernels alone.

Importing this module registers the ops, so a program exported with
``torch.export`` that calls them loads once it is imported. The kernels
(``csrc/*.cu``) are compiled with nvcc at first use
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
            "scatter_max": 0, "batch_norm": 0}

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
# BatchNorm: threads a block (csrc/batch_norm.cu kThreads), blocks a launch
_BN_THREADS = 256
_BN_BLOCKS = 4 * _SMS

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
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
    # csrc/batch_norm.cu's entry points, "batch_norm" its statistics pass
    # (stage 1), each counted under "batch_norm": x, partials, rows, C,
    # bf16, then the form (vec, tile, tiles, rows a block, blocks), stream
    "batch_norm": ("usip_bn_stats", [_P, _P] + [_I] * 8 + [_P]),
    # partials, parts, C, out0, out1, count out (or NULL), count, stream
    "batch_norm.merge": ("usip_bn_merge", [_P, _I, _I, _P, _P, _P, _F, _P]),
    # totals, C, running mean, running var, batches, momentum, eps, mean,
    # rstd, stream
    "batch_norm.finalise": ("usip_bn_finalise",
                            [_P, _I, _P, _P, _P, _D, _D, _P, _P, _P]),
    # x, mean, rstd, w, b, y, rows, C, bf16, relu, form, stream
    "batch_norm.apply": ("usip_bn_apply", [_P] * 6 + [_I] * 9 + [_P]),
    # dy, x, mean, rstd, w, b, partials, rows, C, bf16, relu, form, stream
    "batch_norm.backward_reduce": ("usip_bn_backward_reduce",
                                   [_P] * 7 + [_I] * 9 + [_P]),
    # dy, x, mean, rstd, w, b, sum_g, sum_gx, count, dx, rows, C, bf16,
    # relu, form, stream
    "batch_norm.backward_apply": ("usip_bn_backward_apply",
                                  [_P] * 10 + [_I] * 9 + [_P]),
}
_FNS = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def take_launches(counts: dict, before: dict) -> dict:
    """The launches ``counts`` gained since its copy ``before``, by kernel;
    ``counts`` is set back to ``before``. A CUDA graph's capture records
    launches without running them: its counts are taken off this way and
    given back by ``add_launches`` at each replay."""
    made = {name: counts[name] - before[name] for name in counts}
    counts.update(before)
    return made


def add_launches(counts: dict, made: dict) -> None:
    """Raise ``counts`` by the launches ``made`` (a replay of a graph whose
    capture ``take_launches`` counted)."""
    for name, n in made.items():
        counts[name] += n


def _library(name: str) -> str:
    """The library (``csrc/<library>.cu``, the ``LAUNCHES`` key) of an
    entry point: its name up to the first dot."""
    return name.split(".")[0]


def _kernel_fn(name: str):
    """The ctypes entry point of one kernel, built and loaded at first use."""
    if name not in _FNS:
        from usip_tpu_torch import _build
        symbol, argtypes = _SIGNATURES[name]
        fn = getattr(_build.load(_library(name)), symbol)
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
    LAUNCHES[_library(name)] += 1


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


def _refuse_other_devices(t: Tensor, what: str) -> None:
    """The public wrappers take CPU tensors (the op's plain kernel) and CUDA
    tensors (its CUDA kernel); any other device raises here, before the op's
    fake kernel could answer for it."""
    if t.device.type not in ("cpu", "cuda"):
        _cuda_device(t, what)


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
    """FPS picks ``(B, k)`` int32: the op ``usip::fps``, kernel
    ``csrc/fps.cu`` for CUDA tensors, ``fps_plain`` for CPU tensors.

    Counterpart of ``pallas_kernels.fps_pallas``: one block per cloud, each
    thread's points and running minimum in registers (``fps_form``), one
    barrier a step.
    """
    _refuse_other_devices(points, "points")
    return torch.ops.usip.fps(points, first, k)


@torch.library.custom_op("usip::fps", mutates_args=(), device_types="cpu")
def _fps_op(points: Tensor, first: Tensor, k: int) -> Tensor:
    return fps_plain(points, first, k)


@_fps_op.register_fake
def _fps_fake(points: Tensor, first: Tensor, k: int) -> Tensor:
    return points.new_empty((points.shape[0], k), dtype=torch.int32)


@_fps_op.register_kernel("cuda")
def _fps_cuda(points: Tensor, first: Tensor, k: int) -> Tensor:
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
    ``min_argmin_plain`` for finite inputs. The op is ``usip::min_argmin``;
    ``min_argmin_plain`` for CPU tensors."""
    _refuse_other_devices(points, "points")
    return torch.ops.usip.min_argmin(points, nodes, round_bf16)


@torch.library.custom_op("usip::min_argmin", mutates_args=(),
                         device_types="cpu")
def _min_argmin_op(points: Tensor, nodes: Tensor, round_bf16: bool
                   ) -> Tuple[Tensor, Tensor]:
    mins, idx = min_argmin_plain(points, nodes, round_bf16)
    return mins.contiguous(), idx.contiguous()


@_min_argmin_op.register_fake
def _min_argmin_fake(points: Tensor, nodes: Tensor, round_bf16: bool
                     ) -> Tuple[Tensor, Tensor]:
    shape = tuple(points.shape[:-1])
    return (points.new_empty(shape, dtype=torch.float32),
            points.new_empty(shape, dtype=torch.int32))


@_min_argmin_op.register_kernel("cuda")
def _min_argmin_cuda(points: Tensor, nodes: Tensor, round_bf16: bool
                     ) -> Tuple[Tensor, Tensor]:
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


def _unpack_weights(packed: Tensor, cin: int, c: int, c2: int
                    ) -> Tuple[Tensor, ...]:
    """The folded ``(Cin, Cout)`` bf16 weights ``(w1, w2, w3, w4m, w4h,
    w5)`` read back from a chain's ``packed`` tensor."""
    out, off = [], 0
    for k, n in _chain_dims(cin, c, c2):
        size = math.prod(_packed_shape(k, n))
        out.append(_unpack_layer(packed[off:off + size], k, n))
        off += size
    w1, w2, w3, w4, w5 = out
    return w1, w2, w3, w4[:c], w4[c:], w5


def unpack_chain(chain: FusionChain) -> Tuple[Tensor, ...]:
    """The folded ``(Cin, Cout)`` bf16 weights ``(w1, w2, w3, w4m, w4h, w5)``
    read back from ``chain.packed``."""
    return _unpack_weights(chain.packed, chain.cin,
                           chain.biases[0].shape[0], chain.biases[4].shape[0])


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
    this call only checks it. The op ``usip::fusion_chain`` takes the
    chain's tensors and widths; for CPU tensors it runs
    ``fusion_chain_plain`` on the weights read back from ``chain.packed``
    (the bf16 values the plain version rounds ``chain.weights`` to).
    """
    _refuse_other_devices(grouped, "grouped")
    c, c2 = chain.biases[0].shape[0], chain.biases[4].shape[0]
    return torch.ops.usip.fusion_chain(grouped, chain.packed, *chain.biases,
                                       chain.cin, c, c2)


@torch.library.custom_op("usip::fusion_chain", mutates_args=(),
                         device_types="cpu")
def _fusion_chain_op(grouped: Tensor, packed: Tensor, b1: Tensor, b2: Tensor,
                     b3: Tensor, b4: Tensor, b5: Tensor, cin: int, c: int,
                     c2: int) -> Tensor:
    return fusion_chain_plain(grouped, _unpack_weights(packed, cin, c, c2),
                              (b1, b2, b3, b4, b5))


@_fusion_chain_op.register_fake
def _fusion_chain_fake(grouped: Tensor, packed: Tensor, b1: Tensor,
                       b2: Tensor, b3: Tensor, b4: Tensor, b5: Tensor,
                       cin: int, c: int, c2: int) -> Tensor:
    return grouped.new_empty((grouped.shape[0], grouped.shape[1], c2),
                             dtype=torch.float32)


@_fusion_chain_op.register_kernel("cuda")
def _fusion_chain_cuda(grouped: Tensor, packed: Tensor, b1: Tensor,
                       b2: Tensor, b3: Tensor, b4: Tensor, b5: Tensor,
                       cin: int, c: int, c2: int) -> Tensor:
    dev = _cuda_device(grouped, "grouped")
    b, m, k, gc = grouped.shape
    _check(grouped, "grouped", torch.float32, (b, m, k, gc), dev)
    if gc != cin:
        raise ValueError(f"grouped has {gc} channels, the chain takes {cin}")
    size = sum(math.prod(_packed_shape(kk, n))
               for kk, n in _chain_dims(cin, c, c2))
    _check(packed, "packed weights", torch.bfloat16, (size,), dev)
    biases = (b1, b2, b3, b4, b5)
    for bb, n, name in zip(biases, (c, c, c, c2, c2),
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
        _launch("fusion_chain", dev, grouped.data_ptr(), packed.data_ptr(),
                *(bb.data_ptr() for bb in biases), out.data_ptr(),
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
    keys and picks together do not fit one block, raise. The op is
    ``usip::smallest_k``; ``smallest_k_plain`` for CPU tensors."""
    _refuse_other_devices(scores, "scores")
    if scores.dim() < 1:
        raise ValueError("smallest_k: scores must have a last axis")
    return torch.ops.usip.smallest_k(scores, k)


@torch.library.custom_op("usip::smallest_k", mutates_args=(),
                         device_types="cpu")
def _smallest_k_op(scores: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    vals, idx = smallest_k_plain(scores, k)
    return vals.contiguous(), idx.contiguous()


@_smallest_k_op.register_fake
def _smallest_k_fake(scores: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    _check_k(scores.shape[-1], k)
    shape = tuple(scores.shape[:-1]) + (k,)
    return (scores.new_empty(shape, dtype=torch.float32),
            scores.new_empty(shape, dtype=torch.int32))


@_smallest_k_op.register_kernel("cuda")
def _smallest_k_cuda(scores: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    dev = _cuda_device(scores, "scores")
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
    ``[0, m)`` fails a device assertion. The op is ``usip::scatter_max``;
    ``scatter_max_plain`` for CPU tensors."""
    _refuse_other_devices(f, "f")
    if f.dim() != 3:
        raise ValueError(f"f has shape {tuple(f.shape)}, expected (B, N, C)")
    return torch.ops.usip.scatter_max(f, ids, m)


@torch.library.custom_op("usip::scatter_max", mutates_args=(),
                         device_types="cpu")
def _scatter_max_op(f: Tensor, ids: Tensor, m: int) -> Tensor:
    return scatter_max_plain(f, ids, m)


@_scatter_max_op.register_fake
def _scatter_max_fake(f: Tensor, ids: Tensor, m: int) -> Tensor:
    return f.new_empty((f.shape[0], m, f.shape[2]))


@_scatter_max_op.register_kernel("cuda")
def _scatter_max_cuda(f: Tensor, ids: Tensor, m: int) -> Tensor:
    dev = _cuda_device(f, "f")
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


# -------------------------------------------------- train-mode BatchNorm --
#
# Five stages over rows of C channels (``x (..., C)``, bf16 or fp32): the
# statistics (``batch_norm_stats``: sum, sum of squares and count, one read),
# the finalise (``batch_norm_finalise``: mean, 1/std, the running statistics
# in place), the apply (``batch_norm_apply``: normalise, affine, optional
# ReLU, cast, one read and one write), the backward sums
# (``batch_norm_backward_reduce``: of g and g * x_hat, the bias's and the
# weight's gradients) and the backward apply (``batch_norm_backward_apply``:
# dx). A process group's all-reduce goes between the first two and between
# the last two (``nn/layers.py BatchNorm``). The wrappers take CUDA tensors
# only; the ``*_plain`` stages are the kernels' references.

def batch_norm_stats_plain(x: Tensor) -> Tensor:
    """``(2C + 1,)`` fp32: the per-channel sum of ``x (..., C)`` in fp32, the
    sum of squares, and the count of rows."""
    c = x.shape[-1]
    x32 = x.float().reshape(-1, c)
    return torch.cat([x32.sum(0), x32.square().sum(0),
                      x32.new_full((1,), float(x32.shape[0]))])


def batch_norm_finalise_plain(totals: Tensor, running_mean: Tensor,
                              running_var: Tensor,
                              num_batches_tracked: Tensor, momentum: float,
                              eps: float) -> Tuple[Tensor, Tensor]:
    """``(mean, rstd)`` from ``batch_norm_stats``' totals (of one rank or
    all-reduced over a group): the biased variance ``E[x^2] - E[x]^2``
    clamped at 0; the running statistics move by ``momentum`` towards the
    mean and the unbiased variance, in place, and the batch count rises by
    one (usip_tpu's ``nn/layers.py BatchNorm``)."""
    c = running_mean.shape[0]
    count = totals[2 * c:]
    mean = totals[:c] / count
    var = (totals[c:2 * c] / count - mean.square()).clamp_min(0.0)
    unbiased = var * (count / (count - 1).clamp_min(1.0))
    running_mean.copy_((1.0 - momentum) * running_mean + momentum * mean)
    running_var.copy_((1.0 - momentum) * running_var + momentum * unbiased)
    num_batches_tracked.add_(1)
    return mean, torch.rsqrt(var + eps)


def batch_norm_apply_plain(x: Tensor, mean: Tensor, rstd: Tensor,
                           weight: Tensor, bias: Tensor, relu: bool
                           ) -> Tensor:
    """``act((x - mean) * rstd * weight + bias)`` in fp32, rounded to
    ``x``'s dtype before the ReLU (which keeps the sign)."""
    y = ((x.float() - mean) * rstd * weight + bias).to(x.dtype)
    return torch.relu(y) if relu else y


def _bn_grad_out(dy: Tensor, x: Tensor, mean: Tensor, rstd: Tensor,
                 weight: Tensor, bias: Tensor, relu: bool
                 ) -> Tuple[Tensor, Tensor]:
    """``(g, x_hat)`` fp32: ``dy`` masked by the forward's ReLU (where its
    output, rounded to ``x``'s dtype, is not positive), and ``x_hat``."""
    xhat = (x.float() - mean) * rstd
    g = dy.float()
    if relu:
        z = (xhat * weight + bias).to(x.dtype)
        g = torch.where(z > 0, g, 0.0)
    return g, xhat


def batch_norm_backward_reduce_plain(dy: Tensor, x: Tensor, mean: Tensor,
                                     rstd: Tensor, weight: Tensor,
                                     bias: Tensor, relu: bool
                                     ) -> Tuple[Tensor, Tensor]:
    """``(sum g, sum g * x_hat)`` over the rows, by channel, fp32: the
    bias's and the weight's gradients."""
    g, xhat = _bn_grad_out(dy, x, mean, rstd, weight, bias, relu)
    c = x.shape[-1]
    return g.reshape(-1, c).sum(0), (g * xhat).reshape(-1, c).sum(0)


def batch_norm_backward_apply_plain(dy: Tensor, x: Tensor, mean: Tensor,
                                    rstd: Tensor, weight: Tensor,
                                    bias: Tensor, sum_g: Tensor,
                                    sum_gx: Tensor, count: Tensor,
                                    relu: bool) -> Tensor:
    """``dx = rstd * weight * (g - sum_g / n - x_hat * sum_gx / n)`` in
    ``x``'s dtype; ``sum_g``, ``sum_gx`` and ``count (1,)`` are the group's
    totals where the statistics were."""
    g, xhat = _bn_grad_out(dy, x, mean, rstd, weight, bias, relu)
    dx = rstd * weight * (g - sum_g / count - xhat * (sum_gx / count))
    return dx.to(x.dtype)


class BatchNormForm(NamedTuple):
    """The form of a ``csrc/batch_norm.cu`` row pass: rows cut into vectors
    of ``vec`` channels; a block of 256 threads covers ``tile`` vectors of
    ``256 // tile`` rows at a time, ``tiles`` blocks across a row, and walks
    ``rows_per_block`` rows; ``blocks`` blocks down the rows."""
    vec: int
    tile: int
    tiles: int
    rows_per_block: int
    blocks: int


def batch_norm_form(rows: int, c: int, itemsize: int,
                    pointers: Sequence[int]) -> BatchNormForm:
    """The row passes' form for ``rows`` rows of ``c`` channels of
    ``itemsize`` bytes: the widest vector (16 bytes, then 8, 4, 2, one
    element) that divides ``c`` and to which every pointer is aligned; up to
    256 vectors a block, rows of more in several channel tiles; rows cut
    into chunks (whole multiples of the rows a block covers at a time) for
    about four blocks an SM. (262144, 64) bf16 -> 8 channels a thread, 32
    rows at a time, 512 blocks of 512 rows; (8192, 512) fp32 -> 4 channels,
    2 rows, 512 blocks of 16."""
    if c < 1:
        raise ValueError("batch_norm: rows must have at least one channel")
    vec = 16 // itemsize
    while vec > 1 and (c % vec or any(p % (vec * itemsize)
                                      for p in pointers)):
        vec //= 2
    slots = c // vec
    tile = min(slots, _BN_THREADS)
    tiles = -(-slots // tile)
    per = _BN_THREADS // tile
    want = max(1, _BN_BLOCKS // tiles)
    rows_per_block = -(-max(-(-rows // want), 1) // per) * per
    return BatchNormForm(vec, tile, tiles, rows_per_block,
                         -(-rows // rows_per_block))


def _bn_rows(x: Tensor, what: str, dev: torch.device) -> Tuple[int, int, int]:
    """``(rows, C, bf16)`` of a row tensor the kernels take."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what} has dtype {x.dtype}: the BatchNorm kernels "
                        "take bfloat16 and float32")
    if x.dim() < 1:
        raise ValueError(f"{what} must have a channel axis")
    _check(x, what, x.dtype, x.shape, dev)
    c = x.shape[-1]
    return x.numel() // max(c, 1), c, int(x.dtype == torch.bfloat16)


def _bn_vectors(dev: torch.device, c: int, **vectors: Tensor) -> None:
    for what, t in vectors.items():
        _check(t, what, torch.float32, (c,), dev)


def batch_norm_stats(x: Tensor) -> Tensor:
    """``batch_norm_stats_plain``'s totals; kernel ``csrc/batch_norm.cu``
    for CUDA tensors (one read of ``x``, per-block partials merged in a
    fixed order). The op is ``usip::batch_norm_stats``."""
    _cuda_device(x, "x")
    return torch.ops.usip.batch_norm_stats(x)


def _bn_merge(dev: torch.device, partials: Tensor, parts: int, c: int,
              out0: int, out1: int, count_out, count: float) -> None:
    _launch("batch_norm.merge", dev, partials.data_ptr(), parts, c, out0,
            out1, count_out, count)


@torch.library.custom_op("usip::batch_norm_stats", mutates_args=(),
                         device_types="cuda")
def _bn_stats_op(x: Tensor) -> Tensor:
    dev = _cuda_device(x, "x")
    rows, c, bf16 = _bn_rows(x, "x", dev)
    form = batch_norm_form(rows, c, x.element_size(), (x.data_ptr(),))
    partials = torch.empty((form.blocks, 2 * c), dtype=torch.float32,
                           device=dev)
    totals = torch.empty((2 * c + 1,), dtype=torch.float32, device=dev)
    if form.blocks:
        _launch("batch_norm", dev, x.data_ptr(), partials.data_ptr(), rows,
                c, bf16, *form)
    base = totals.data_ptr()
    _bn_merge(dev, partials, form.blocks, c, base, base + 4 * c,
              base + 8 * c, float(rows))
    return totals


@_bn_stats_op.register_fake
def _bn_stats_fake(x: Tensor) -> Tensor:
    return x.new_empty((2 * x.shape[-1] + 1,), dtype=torch.float32)


def batch_norm_finalise(totals: Tensor, running_mean: Tensor,
                        running_var: Tensor, num_batches_tracked: Tensor,
                        momentum: float, eps: float) -> Tuple[Tensor, Tensor]:
    """``batch_norm_finalise_plain``; kernel ``csrc/batch_norm.cu`` for
    CUDA tensors (one thread a channel, the count read on the device). The
    op is ``usip::batch_norm_finalise``."""
    _cuda_device(totals, "totals")
    return torch.ops.usip.batch_norm_finalise(
        totals, running_mean, running_var, num_batches_tracked, momentum, eps)


@torch.library.custom_op(
    "usip::batch_norm_finalise",
    mutates_args=("running_mean", "running_var", "num_batches_tracked"),
    device_types="cuda")
def _bn_finalise_op(totals: Tensor, running_mean: Tensor, running_var: Tensor,
                    num_batches_tracked: Tensor, momentum: float, eps: float
                    ) -> Tuple[Tensor, Tensor]:
    dev = _cuda_device(totals, "totals")
    c = running_mean.shape[0]
    _check(totals, "totals", torch.float32, (2 * c + 1,), dev)
    _bn_vectors(dev, c, running_mean=running_mean, running_var=running_var)
    _check(num_batches_tracked, "num_batches_tracked", torch.int64, (), dev)
    mean = torch.empty((c,), dtype=torch.float32, device=dev)
    rstd = torch.empty((c,), dtype=torch.float32, device=dev)
    _launch("batch_norm.finalise", dev, totals.data_ptr(), c,
            running_mean.data_ptr(), running_var.data_ptr(),
            num_batches_tracked.data_ptr(), float(momentum), float(eps),
            mean.data_ptr(), rstd.data_ptr())
    return mean, rstd


@_bn_finalise_op.register_fake
def _bn_finalise_fake(totals, running_mean, running_var, num_batches_tracked,
                      momentum, eps):
    c = running_mean.shape[0]
    return totals.new_empty((c,)), totals.new_empty((c,))


def batch_norm_apply(x: Tensor, mean: Tensor, rstd: Tensor, weight: Tensor,
                     bias: Tensor, relu: bool) -> Tensor:
    """``batch_norm_apply_plain``; kernel ``csrc/batch_norm.cu`` for CUDA
    tensors (one read of ``x``, one write in its dtype). The op is
    ``usip::batch_norm_apply``."""
    _cuda_device(x, "x")
    return torch.ops.usip.batch_norm_apply(x, mean, rstd, weight, bias, relu)


@torch.library.custom_op("usip::batch_norm_apply", mutates_args=(),
                         device_types="cuda")
def _bn_apply_op(x: Tensor, mean: Tensor, rstd: Tensor, weight: Tensor,
                 bias: Tensor, relu: bool) -> Tensor:
    dev = _cuda_device(x, "x")
    rows, c, bf16 = _bn_rows(x, "x", dev)
    _bn_vectors(dev, c, mean=mean, rstd=rstd, weight=weight, bias=bias)
    y = torch.empty_like(x)
    form = batch_norm_form(rows, c, x.element_size(),
                           (x.data_ptr(), y.data_ptr()))
    if form.blocks:
        _launch("batch_norm.apply", dev, x.data_ptr(), mean.data_ptr(),
                rstd.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                y.data_ptr(), rows, c, bf16, int(relu), *form)
    return y


@_bn_apply_op.register_fake
def _bn_apply_fake(x, mean, rstd, weight, bias, relu):
    return x.new_empty(x.shape)


def batch_norm_backward_reduce(dy: Tensor, x: Tensor, mean: Tensor,
                               rstd: Tensor, weight: Tensor, bias: Tensor,
                               relu: bool) -> Tuple[Tensor, Tensor]:
    """``batch_norm_backward_reduce_plain``; kernel ``csrc/batch_norm.cu``
    for CUDA tensors (one read of ``dy`` and ``x``, per-block partials
    merged in a fixed order). The op is ``usip::batch_norm_backward_reduce``.
    """
    _cuda_device(x, "x")
    return torch.ops.usip.batch_norm_backward_reduce(dy, x, mean, rstd,
                                                     weight, bias, relu)


@torch.library.custom_op("usip::batch_norm_backward_reduce", mutates_args=(),
                         device_types="cuda")
def _bn_bwd_reduce_op(dy: Tensor, x: Tensor, mean: Tensor, rstd: Tensor,
                      weight: Tensor, bias: Tensor, relu: bool
                      ) -> Tuple[Tensor, Tensor]:
    dev = _cuda_device(x, "x")
    rows, c, bf16 = _bn_rows(x, "x", dev)
    _check(dy, "dy", x.dtype, x.shape, dev)
    _bn_vectors(dev, c, mean=mean, rstd=rstd, weight=weight, bias=bias)
    form = batch_norm_form(rows, c, x.element_size(),
                           (x.data_ptr(), dy.data_ptr()))
    partials = torch.empty((form.blocks, 2 * c), dtype=torch.float32,
                           device=dev)
    sum_g = torch.empty((c,), dtype=torch.float32, device=dev)
    sum_gx = torch.empty((c,), dtype=torch.float32, device=dev)
    if form.blocks:
        _launch("batch_norm.backward_reduce", dev, dy.data_ptr(),
                x.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                weight.data_ptr(), bias.data_ptr(), partials.data_ptr(),
                rows, c, bf16, int(relu), *form)
    _bn_merge(dev, partials, form.blocks, c, sum_g.data_ptr(),
              sum_gx.data_ptr(), None, 0.0)
    return sum_g, sum_gx


@_bn_bwd_reduce_op.register_fake
def _bn_bwd_reduce_fake(dy, x, mean, rstd, weight, bias, relu):
    c = x.shape[-1]
    return (x.new_empty((c,), dtype=torch.float32),
            x.new_empty((c,), dtype=torch.float32))


def batch_norm_backward_apply(dy: Tensor, x: Tensor, mean: Tensor,
                              rstd: Tensor, weight: Tensor, bias: Tensor,
                              sum_g: Tensor, sum_gx: Tensor, count: Tensor,
                              relu: bool) -> Tensor:
    """``batch_norm_backward_apply_plain``; kernel ``csrc/batch_norm.cu``
    for CUDA tensors (one read of ``dy`` and ``x``, one write of ``dx`` in
    ``x``'s dtype). The op is ``usip::batch_norm_backward_apply``."""
    _cuda_device(x, "x")
    return torch.ops.usip.batch_norm_backward_apply(
        dy, x, mean, rstd, weight, bias, sum_g, sum_gx, count, relu)


@torch.library.custom_op("usip::batch_norm_backward_apply", mutates_args=(),
                         device_types="cuda")
def _bn_bwd_apply_op(dy: Tensor, x: Tensor, mean: Tensor, rstd: Tensor,
                     weight: Tensor, bias: Tensor, sum_g: Tensor,
                     sum_gx: Tensor, count: Tensor, relu: bool) -> Tensor:
    dev = _cuda_device(x, "x")
    rows, c, bf16 = _bn_rows(x, "x", dev)
    _check(dy, "dy", x.dtype, x.shape, dev)
    _bn_vectors(dev, c, mean=mean, rstd=rstd, weight=weight, bias=bias,
                sum_g=sum_g, sum_gx=sum_gx)
    _check(count, "count", torch.float32, (1,), dev)
    dx = torch.empty_like(x)
    form = batch_norm_form(rows, c, x.element_size(),
                           (x.data_ptr(), dy.data_ptr(), dx.data_ptr()))
    if form.blocks:
        _launch("batch_norm.backward_apply", dev, dy.data_ptr(),
                x.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                weight.data_ptr(), bias.data_ptr(), sum_g.data_ptr(),
                sum_gx.data_ptr(), count.data_ptr(), dx.data_ptr(), rows, c,
                bf16, int(relu), *form)
    return dx


@_bn_bwd_apply_op.register_fake
def _bn_bwd_apply_fake(dy, x, mean, rstd, weight, bias, sum_g, sum_gx, count,
                       relu):
    return x.new_empty(x.shape)
