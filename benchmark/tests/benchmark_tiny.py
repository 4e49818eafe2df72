"""Tiny configurations of the benchmark's cells for runs on the CPU: the
same drivers, references and limits, at sizes a test can hold."""

from __future__ import annotations

import argparse
import copy
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

CELLS = ("kitti-som.train", "kitti-desc.train", "kitti-som.detect",
         "kitti-desc.serve")
# cells whose drivers, references and limits are here but which
# BENCHMARK.json leaves out: their runs on the card spread wider than the
# largest bound a cell may have (PERF.md, open questions)
PENDING = {
    "kitti-desc.train": {"config": "kitti-desc", "traffic": "kitti-train"},
    "kitti-desc.serve": {"config": "kitti-desc",
                         "traffic": "kitti-scan-closed1"},
}
PENDING_CONFIG = {"name": "kitti-desc",
                  "file": "benchmark/configs/kitti-desc.json"}


def spec_with(cell: str, root: str = ROOT) -> dict:
    """``BENCHMARK.json``, with ``cell`` added where it is a pending one."""
    bench = harness.spec(root)
    if cell in PENDING and cell not in {w["name"]
                                        for w in bench["workloads"]}:
        bench["workloads"].append({"name": cell, "chips": 1,
                                   **PENDING[cell]})
        if PENDING_CONFIG["name"] not in {c["name"]
                                          for c in bench["configs"]}:
            bench["configs"].append(PENDING_CONFIG)
    return bench


def tiny_config(config: dict, dtype: str = "float32") -> dict:
    c = copy.deepcopy(config)
    c["sizes"].update(input_pc_num=512, parent_pc_num=640, node_num=32,
                      c1=16, c2=32, node_knn_k=4, batch_size=2,
                      compute_dtype=dtype)
    if "descriptor_len" in c["sizes"]:
        c["sizes"].update(node_num=16, descriptor_len=32, ball_nsamples=16,
                          descriptor_compute_dtype=dtype,
                          ball_compute_dtype=dtype)
    return c


def tiny_traffic(traffic: dict) -> dict:
    t = dict(traffic)
    kind = t["kind"]
    if kind == "train_engine":
        t.update(sequences=9, frames_per_seq=2, points=640)
    elif kind == "detect_batch":
        t.update(batch=2, pool_clouds=4, points=640, warmup_batches=1,
                 checked_batches=2)
    elif kind == "serve_closed_loop":
        t.update(pool_scans=3, points=640, warmup_requests=1,
                 checked_requests=2, num_keypoints=8)
    return t


def tiny_context(cell: str, seed: int = 2 ** 31 + 77, seconds: float = 1.0,
                 trace: int = 0, dtype: str = "float32",
                 root: str = ROOT) -> harness.RunContext:
    """A CPU run's context of ``cell`` at the tiny sizes, the cell's own
    limits."""
    bench = spec_with(cell, root)
    c = harness.find_cell(bench, cell)
    args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds,
                              trace=trace)
    return harness.RunContext(
        args, time.perf_counter(), device="cpu",
        config=tiny_config(harness.config_file(bench, c["config"], root),
                           dtype),
        traffic=tiny_traffic(harness.traffic_file(c["traffic"], root)),
        root=root, bench=bench)
