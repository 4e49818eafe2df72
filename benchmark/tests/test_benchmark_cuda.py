"""On the card, at each cell's own size: the program's numbers on three
seeds sit under the cell's limits, and the control's (the reference in
float8 in the program's place) break at least one of them. Run on the
chip: ``python -m pytest benchmark/tests -m cuda``."""

from __future__ import annotations

import argparse
import time

import pytest
import torch

from benchmark_tiny import CELLS, spec_with

from benchmark import harness

SEEDS = (2 ** 31 + 1001, 2 ** 31 + 1002, 2 ** 31 + 1003)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run the port's CUDA "
                    "kernels at their full sizes")
    harness.cache_dirs()
    for seed in SEEDS:
        args = argparse.Namespace(workload=cell, seed=seed, seconds=2.0,
                                  trace=0)
        ctx = harness.RunContext(args, time.perf_counter(),
                                 bench=spec_with(cell))
        found = harness.mix_module(ctx.traffic["kind"]).calibration(ctx, True)
        limits = ctx.limits
        prog = {k: found["program"][k] for k in limits}
        ctrl = {k: found["control"][k] for k in limits}
        assert all(v <= limits[k] for k, v in prog.items()), found
        assert any(v > limits[k] for k, v in ctrl.items()), found
