"""The device's busy time a request in the traced part of a serve cell's
window: kernels, copies and sets, from the profiler's trace."""


def read(w):
    t = w.trace
    if t is None or not t["work"] or t["busy_s"] <= 0:
        return None
    return 1e3 * t["busy_s"] / t["work"]
