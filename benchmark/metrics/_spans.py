"""Idle shares by the program's spans. ``reduce_trace`` labels each idle
gap of the traced window with the innermost user span the host was in at
its middle; the port names its parts ``usip.*`` (``utils/logging.py
span``), and torch names its own optimizer calls ``Optimizer.<call>#...``
inside them."""

from __future__ import annotations

from benchmark.harness import BREAKDOWN_TOP

PROGRAM = "usip."


def idle_in(w, labels, prefixes=()):
    """100 x the traced window's idle seconds labelled one of ``labels``,
    or starting with one of ``prefixes``, over the window: in the unit of
    ``idle_share``. None where no label is the program's (no trace, the
    CPU, a program without spans); 0.0 where its spans held no gap. The
    trace keeps only the ``BREAKDOWN_TOP`` largest labels: where the list
    is that long and none of these labels is in it, they may have been
    cut, and it reads None too."""
    if w.trace is None or w.trace["window_s"] <= 0:
        return None
    gaps = w.trace["idle_gaps"]
    if not any(label.startswith(PROGRAM) for label, _ in gaps):
        return None
    mine = [s for label, s in gaps
            if label in labels or label.startswith(tuple(prefixes))]
    if not mine and len(gaps) >= BREAKDOWN_TOP:
        return None
    return 100.0 * sum(mine) / w.trace["window_s"]
