#!/usr/bin/env python3
"""The benchmark of usip_tpu_torch, the PyTorch/CUDA port: one run of one
cell of ``BENCHMARK.json``.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. The cell names a configuration
(``benchmark/configs/<config>.json``) and a traffic mix
(``benchmark/traffic/<traffic>.json``, whose ``kind`` names its driver,
``benchmark/mixes/<kind>.py``). The run sets up, warms up the cell's shapes,
measures for ``--seconds``, checks what the timed path produced against the
plain reference (``benchmark/reference/``) and prints one JSON line last.
With ``--trace 1`` it reports the cell's per-layer metrics, each read by
``benchmark/metrics/<metric>.py``, instead of the end-to-end ones.
"""

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark import harness
    return harness.run_cell(args, PROCESS_START)


if __name__ == "__main__":
    sys.exit(main())
