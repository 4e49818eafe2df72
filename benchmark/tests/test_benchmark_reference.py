"""The plain reference against the port's own plain path on the CPU at a
small size: the train steps, the eval forwards, the ball query; the
control reads higher than a sound run; the reference loads nothing of the
program."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest
import torch

from benchmark_tiny import ROOT, tiny_config, tiny_context

from benchmark import harness
from benchmark.reference import common
from benchmark.reference import descriptor as desc_ref
from benchmark.reference import detector as ref
from benchmark.weights import (descriptor_weights, detector_weights,
                               port_config)


@pytest.mark.parametrize("cell", ["kitti-som.train", "kitti-desc.train"])
def test_train_steps_follow_the_port(cell):
    """The port's fp32 steps (the captured steps of a tiny run) against
    the reference's from the same weights, batches and draws."""
    ctx = tiny_context(cell)
    mix = harness.mix_module("train_engine")
    s = mix.setup(ctx)
    record = mix.program_record(s)
    mix.release(ctx, s)
    found = mix.gaps(record, mix.reference_record(s))
    assert found["loss_gap"] < 1e-5, found
    assert found["grad_gap"] < 2e-3, found


def _config(name):
    return tiny_config(harness.load_json(
        os.path.join(ROOT, "benchmark", "configs", name + ".json")))


def test_eval_forward_follows_the_port():
    from usip_tpu_torch.models.detector import Detector
    config = _config("kitti-som")
    z = ref.sizes_from(config)
    weights = detector_weights(z, 3, "cpu", head="he")
    det = Detector(port_config(config).detector)
    det.load_state_dict(weights)
    det.eval()
    g = torch.Generator().manual_seed(0)
    pc = 10 * torch.rand((2, z.input_pc_num, 3), generator=g)
    sn = torch.rand((2, z.input_pc_num, z.surface_normal_len), generator=g)
    node = pc[:, :z.node_num]
    with torch.no_grad():
        _, kp, sig = det(pc, sn, node)
    kp_r, sig_r = ref.eval_forward(weights, z, pc, sn, node)
    assert torch.allclose(kp, kp_r, atol=1e-4, rtol=1e-4)
    assert torch.allclose(sig, sig_r, atol=1e-4, rtol=1e-4)


def test_descriptor_eval_follows_the_port():
    from usip_tpu_torch.models.descriptor import Descriptor
    config = _config("kitti-desc")
    d = desc_ref.desc_sizes_from(config)
    weights = descriptor_weights(d, 3, "cpu")
    model = Descriptor(port_config(config).descriptor)
    model.load_state_dict(weights)
    model.eval()
    g = torch.Generator().manual_seed(1)
    n = 512
    pc = 6 * torch.rand((2, n, 3), generator=g)
    sn = torch.rand((2, n, d.surface_normal_len), generator=g)
    kp = pc[:, :16] + 0.1
    priority = torch.rand((2, n), generator=g)
    with torch.no_grad():
        want, _ = model(pc, sn, kp, priority)
    got = desc_ref.eval_describe(weights, d, pc, sn, kp, priority)
    assert torch.allclose(got, want, atol=1e-5)


def test_ball_query_pads_cyclically_and_empties_to_zero():
    pc = torch.tensor([[[0.0, 0, 0], [0.5, 0, 0], [9.0, 0, 0]]])
    centres = torch.tensor([[[0.0, 0, 0], [50.0, 0, 0]]])
    priority = torch.tensor([[0.9, 0.1, 0.5]])
    idx = desc_ref.ball_query(pc, centres, priority, 1.0, 4)
    assert idx.tolist() == [[[1, 0, 1, 0], [0, 0, 0, 0]]]


@pytest.mark.parametrize("cell", ["kitti-som.train", "kitti-som.detect"])
def test_control_reads_higher_than_a_sound_run(cell):
    """The control (the reference in float8 in the program's place) reads
    far above the port's fp32 run at the tiny size."""
    ctx = tiny_context(cell, seconds=0.5)
    found = harness.mix_module(ctx.traffic["kind"]).calibration(ctx, True)
    prog, ctrl = found["program"], found["control"]
    assert max(ctrl[k] / max(prog[k], 1e-9) for k in prog) > 10, found


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.common, benchmark.reference.detector,"
            " benchmark.reference.descriptor\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'usip_tpu',"
            " 'usip_tpu_torch'))\n"
            "print(bad)\n" % ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "[]"


def test_fp8_rounds_coarser_than_bf16():
    x = torch.linspace(0.1, 3.0, 1000)
    fp8 = (common.Precision("fp8").q(x) - x).abs().max()
    bf16 = (x.to(torch.bfloat16).float() - x).abs().max()
    assert fp8 > 8 * bf16
