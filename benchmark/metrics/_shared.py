"""Arithmetic the per-layer readers share. Each reader,
``benchmark/metrics/<metric>.py``, has ``read(window) -> float | None``
and returns None where its window holds nothing to read (no trace: an
untraced or CPU run; no span; a kernel not launched)."""

from __future__ import annotations

# NVIDIA's data sheet: H100 SXM bf16 dense tensor-core peak, FLOP/s
BF16_PEAK = 989e12


def mean_ms(values_s):
    return 1e3 * sum(values_s) / len(values_s) if values_s else None


def mean(values):
    return sum(values) / len(values) if values else None


def mfu(w):
    """Model FLOPs of the work done over the wall time at the bf16 peak,
    in %; only from a card's traced run."""
    if w.trace is None or not w.work or not w.flops_per_work:
        return None
    return 100.0 * w.work * w.flops_per_work / (w.wall_s * BF16_PEAK)


def idle_share(w):
    """1 - the device's busy time over the traced window, in %."""
    if w.trace is None or w.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - w.trace["busy_s"] / w.trace["window_s"])


def roofline(w, kernel: str, pattern: str):
    """The kernel's least time (its bound at the cell's shapes times its
    launches in the traced window) over its device time there, in %."""
    if w.trace is None or kernel not in w.bounds:
        return None
    bound_ms, launches = w.bounds[kernel]
    spent = sum(v for k, v in w.trace["kernel_s"].items() if pattern in k)
    if not launches or spent <= 0:
        return None
    return 100.0 * bound_ms * 1e-3 * launches / spent
