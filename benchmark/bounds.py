"""The least time an H100 could take for a kernel's work, from the shapes
the cell runs: the larger of the bytes it must move (each input read once,
each output written once) over the memory rate and the operations it must
do over their peak. A frozen copy of ``chip_smoke.py``'s ``bound``,
``min_argmin_bound``, ``kernel_bounds`` and ``chain_bound``.

Peaks: NVIDIA's data sheet for the H100 SXM, dense, at its 700 W limit.
"""

from __future__ import annotations

from typing import Dict, Tuple

HBM_BPS, BF16_FLOPS, FP32_FLOPS = 3.35e12, 989e12, 67e12
B_BENCH = 8


def bound(nbytes: float, flops: float, peak: float) -> Tuple[float, str]:
    """The least time in ms and which of the two sets it."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fps_bound(b: int, s: int, k: int) -> Tuple[float, str]:
    """FPS of ``k`` picks over ``b`` clouds of ``s`` points: 8 FLOP a point
    and step (3 differences, 3 squares, 2 sums)."""
    return bound(b * s * 12 + b * 4 + b * k * 4, 8 * b * (k - 1) * s,
                 FP32_FLOPS)


def min_argmin_bound(b: int, n: int, m: int) -> Tuple[float, str]:
    """Points and candidates read, a min and an index written; 8 FLOP a
    pair."""
    return bound(b * n * 12 + b * m * 12 + b * n * 8, 8 * b * n * m,
                 FP32_FLOPS)


def chain_bound(b: int, m: int, k: int, cin: int, c: int, c2: int
                ) -> Tuple[float, str]:
    """The fused kNN-fusion chain at ``(b, m, k, cin) -> (b, m, c2)``: its
    bf16 products over the tensor cores' rate, or the input read, the
    output written and the weights read once over the memory rate."""
    rows = b * m * k
    flops = 2 * rows * (cin * c + 2 * c * c + c * c2 + c2 * c2) \
        + 2 * b * m * c * c2
    nbytes = rows * cin * 4 + b * m * c2 * 4 + 2 * (
        cin * c + 2 * c * c + 2 * c * c2 + c2 * c2)
    return bound(nbytes, flops, BF16_FLOPS)


def kernel_bounds(c1: int, c2: int, k_node: int) -> Dict[str, Tuple]:
    """Each kernel's bound at the KITTI detect shapes (batch 8)."""
    b, s, kf, n, m = B_BENCH, 2048, 512, 16384, 512
    return {
        "fps": fps_bound(b, s, kf),
        "min_argmin": min_argmin_bound(b, n, m),
        "fusion_chain": chain_bound(b, m, k_node, 3 + c1, c2 // 2, c2),
        "smallest_k": bound(b * m * n * 4 + b * m * 64 * 8, 0, FP32_FLOPS),
        "scatter_max": bound(sum(b * n * cc * 4 + b * n * 8 + b * m * cc * 4
                                 for cc in (64, 128)), 0, FP32_FLOPS),
    }
