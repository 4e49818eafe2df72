"""Observability: console metrics lines, JSONL metric streams, cloud
snapshots (counterpart of ``usip_tpu/utils/logging.py``; the port keeps its
own copy).

Replaces the reference's visdom-based Visualizer (util/visualizer.py): console
printer (print_current_errors), loss curves (plot_current_errors -> metrics.jsonl,
plottable offline), and 3D keypoint scatter payloads (display_current_results ->
.npz snapshots of cloud/nodes/keypoints/sigmas). Under ``torch.distributed``
only rank 0 writes and prints (usip_tpu logs from its first host only)."""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict

import numpy as np


def _is_main_process() -> bool:
    import torch.distributed as dist
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def notice(message: str) -> None:
    """``message`` on stderr (rank 0 only): a one-off notice, such as which
    host loader path ``native.py`` took and why, that the metric streams
    must not carry."""
    if _is_main_process():
        print(message, file=sys.stderr, flush=True)


class MetricsLogger:
    def __init__(self, out_dir: str, name: str = "train"):
        self.out_dir = out_dir
        self.path = os.path.join(out_dir, f"{name}_metrics.jsonl")
        # every rank computes the same metrics; one writes them
        self.enabled = _is_main_process()
        self._fh = None
        if self.enabled:
            os.makedirs(out_dir, exist_ok=True)
            self._fh = open(self.path, "a")
        self._t0 = time.time()

    def log(self, step: int, epoch: int, metrics: Dict[str, float],
            prefix: str = "train") -> None:
        """One JSONL record and one console line (rank 0 only)."""
        if not self.enabled:
            return
        record = {"step": step, "epoch": epoch, "prefix": prefix,
                  "wall": round(time.time() - self._t0, 3)}
        record.update({k: float(v) for k, v in metrics.items()})
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()
        body = ", ".join(f"{k}: {float(v):.4f}" for k, v in metrics.items())
        print(f"[{prefix}] epoch {epoch} step {step} | {body}", flush=True)

    def snapshot_clouds(self, tag: str, step: int, **arrays) -> str:
        """Dump named point arrays (pc/nodes/keypoints/sigmas) for offline 3D
        inspection, the visdom scatter payload's equivalent
        (keypoint_detector.py:259-334). Rank 0 only; None elsewhere."""
        if not self.enabled:
            return None
        vis_dir = os.path.join(self.out_dir, "visuals")
        os.makedirs(vis_dir, exist_ok=True)
        path = os.path.join(vis_dir, f"{tag}_{step}.npz")
        np.savez_compressed(path, **{k: np.asarray(v) for k, v in arrays.items()})
        return path

    def close(self):
        if self._fh is not None:
            self._fh.close()


class RunningAverages:
    """Weighted running averages for the per-epoch test sweep
    (modelnet/train_detector.py:73-103)."""

    def __init__(self):
        self._sums: Dict[str, float] = {}
        self._weight = 0.0

    def update(self, metrics: Dict[str, float], weight: float = 1.0):
        for k, v in metrics.items():
            self._sums[k] = self._sums.get(k, 0.0) + float(v) * weight
        self._weight += weight

    def averages(self) -> Dict[str, float]:
        if self._weight == 0:
            return {}
        return {k: v / self._weight for k, v in self._sums.items()}


class Throughput:
    """Clouds/s, the north-star runtime metric; the engines count every
    rank's clouds (the global batch), as usip_tpu's ``Throughput`` does."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._clouds = 0

    def add(self, clouds: int):
        self._clouds += clouds

    def rate(self) -> float:
        dt = time.perf_counter() - self._t0
        if dt <= 0:
            return 0.0
        return self._clouds / dt
