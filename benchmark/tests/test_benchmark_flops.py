"""The yardstick's arithmetic: model FLOPs from shapes, and the kernel
bounds, which are a frozen copy of ``chip_smoke.py``'s."""

from __future__ import annotations

import json
import os
import sys

import pytest

from benchmark_tiny import ROOT

from benchmark import bounds, flops


def _sizes(name):
    with open(os.path.join(ROOT, "benchmark", "configs", name + ".json")) as f:
        return json.load(f)["sizes"]


def test_detector_flops_at_the_kitti_widths():
    s = _sizes("kitti-som")
    # PN1 0.1416, PN2 0.5369, fusion 4.6380, head 0.2352 GMAC a cloud
    assert flops.detector_forward_flops(s) == pytest.approx(11.1013e9,
                                                            rel=1e-4)
    step = 2 * s["batch_size"] * flops.detector_train_flops(s)
    assert step == pytest.approx(532.86e9, rel=1e-4)


def test_descriptor_flops_at_the_kitti_widths():
    s = _sizes("kitti-desc")
    rows = 256 * 64
    macs = rows * (7 * 32 + 32 * 64 + 64 * 128 + 256 * 128 + 128 * 128)
    assert flops.descriptor_forward_macs(256, 64, 128, 4) == macs
    assert flops.descriptor_train_flops(s) == pytest.approx(
        flops.detector_forward_flops(s) + 6.0 * macs)


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, ROOT)
    import chip_smoke as module
    return module


def test_bounds_reproduce_chip_smoke(chip_smoke):
    assert bounds.kernel_bounds(128, 512, 16) == chip_smoke.kernel_bounds(
        128, 512, 16)
    for shape in [(8, 512, 16, 131, 256, 512), (8, 512, 4, 67, 128, 256),
                  (8, 512, 32, 131, 256, 512)]:
        assert bounds.chain_bound(*shape) == chip_smoke.chain_bound(*shape)
    for b, n, m, _ in chip_smoke.K2_SHAPES.values():
        assert bounds.min_argmin_bound(b, n, m) == \
            chip_smoke.min_argmin_bound(b, n, m)
    assert (bounds.HBM_BPS, bounds.BF16_FLOPS, bounds.FP32_FLOPS) == (
        chip_smoke.HBM_BPS, chip_smoke.BF16_FLOPS, chip_smoke.FP32_FLOPS)


def test_detect_cell_bounds():
    """K3 at (8, 512, 16, 131) -> 512 and K1 at (8, 2048) -> 512: the
    bounds the detect cell's rooflines divide by."""
    assert bounds.chain_bound(8, 512, 16, 131, 256, 512)[0] == \
        pytest.approx(0.0750, abs=1e-4)
    assert bounds.fps_bound(8, 2048, 512)[0] == pytest.approx(0.0010,
                                                              abs=1e-4)
