"""The port's own host code against usip_tpu's, on the CPU.

usip_tpu_torch imports nothing of usip_tpu: it keeps its own copies of the
config presets, ``subsample_fixed``, the export tool's keypoint selection and
the CLI's ``_sn_columns``. These tests hold each copy equal to usip_tpu's on
the same inputs, and show in a fresh interpreter that importing the port
loads no ``usip_tpu`` module.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from usip_tpu import cli as jax_cli
from usip_tpu import config as jax_config
from usip_tpu.data.common import subsample_fixed as jax_subsample_fixed
from usip_tpu.eval import export as jax_export
from usip_tpu_torch import cli as torch_cli
from usip_tpu_torch import config as torch_config
from usip_tpu_torch.data.common import subsample_fixed
from usip_tpu_torch.eval import export as torch_export

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATASETS = sorted(jax_config.PRESETS)
OVERRIDES = {"data.input_pc_num": 4096, "detector.grouping": "ball",
             "train.epochs": 3}


@pytest.mark.parametrize("role", ["detector", "descriptor"])
@pytest.mark.parametrize("dataset", DATASETS)
def test_config_presets_equal_usip_tpu(dataset, role):
    """Every preset and role, with and without dotted overrides."""
    assert sorted(torch_config.PRESETS) == DATASETS
    for overrides in ({}, OVERRIDES):
        ours = torch_config.get_config(dataset, role, **overrides)
        ref = jax_config.get_config(dataset, role, **overrides)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert json.loads(ours.to_json()) == json.loads(ref.to_json())
    assert (dataclasses.asdict(torch_config.lite_detector(ours.detector))
            == dataclasses.asdict(jax_config.lite_detector(ref.detector)))


def test_config_rejects_what_usip_tpu_rejects():
    for fn in (torch_config.get_config, jax_config.get_config):
        with pytest.raises(KeyError):
            fn("nowhere")
        with pytest.raises(ValueError):
            fn("kitti", role="trainer")


@pytest.mark.parametrize("m,n", [(5000, 4096), (4096, 4096), (1500, 4096),
                                 (7, 100)])
def test_subsample_fixed_equals_usip_tpu(m, n):
    """Same seed, same rows (longer and shorter clouds than n)."""
    data = np.random.default_rng(m).normal(size=(m, 7)).astype(np.float32)
    ours = subsample_fixed(np.random.default_rng(3), data, n)
    ref = jax_subsample_fixed(np.random.default_rng(3), data, n)
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("nms_radius", [0.0, 0.5])
@pytest.mark.parametrize("desired", [16, 64, 300])
@pytest.mark.parametrize("return_sigmas", [False, True])
def test_select_keypoints_equals_usip_tpu(nms_radius, desired,
                                          return_sigmas):
    """NMS on and off, desired_num above and below M=128 proposals."""
    rng = np.random.default_rng(desired)
    kp = rng.uniform(-3, 3, size=(128, 3)).astype(np.float32)
    sig = rng.uniform(0, 1, size=128).astype(np.float32)
    pc = rng.normal(size=(2000, 3)).astype(np.float32)
    kw = dict(nms_radius=nms_radius, desired_num=desired,
              return_sigmas=return_sigmas)
    ours = torch_export.select_keypoints(kp, sig, pc,
                                         rng=np.random.default_rng(9), **kw)
    ref = jax_export.select_keypoints(kp, sig, pc,
                                      rng=np.random.default_rng(9), **kw)
    for a, b in zip(ours if return_sigmas else [ours],
                    ref if return_sigmas else [ref]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        torch_export.select_keypoint_indices(kp, sig, nms_radius=nms_radius,
                                             desired_num=desired),
        jax_export.select_keypoint_indices(kp, sig, nms_radius=nms_radius,
                                           desired_num=desired))
    for got, want in zip(torch_export.nms(kp, sig, nms_radius),
                         jax_export.nms(kp, sig, nms_radius)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num", [50, 128, 200])
def test_ensure_keypoint_number_equals_usip_tpu(num):
    rng = np.random.default_rng(num)
    kp = rng.normal(size=(128, 3)).astype(np.float32)
    pc = rng.normal(size=(1000, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        torch_export.ensure_keypoint_number(kp, pc, num,
                                            np.random.default_rng(1)),
        jax_export.ensure_keypoint_number(kp, pc, num,
                                          np.random.default_rng(1)))


@pytest.mark.parametrize("cols,s", [(3, 4), (5, 4), (7, 4), (9, 4), (4, 1)])
def test_sn_columns_equals_usip_tpu(cols, s):
    """No normals, fewer channels than the model wants (zero-padded),
    exactly as many, and more (cut)."""
    data = np.random.default_rng(cols).normal(size=(50, cols))
    ours = torch_cli._sn_columns(data, s)
    ref = jax_cli._sn_columns(data, s)
    if ref is None:
        assert ours is None
    else:
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)


def test_port_imports_nothing_of_usip_tpu():
    """A fresh interpreter imports the port's modules and finds neither
    ``usip_tpu`` nor any ``usip_tpu.*`` module loaded (``usip_tpu_torch``
    shares the prefix, so the match is exact)."""
    code = (
        "import sys\n"
        "import usip_tpu_torch.cli, usip_tpu_torch.inference\n"
        "import usip_tpu_torch.models, usip_tpu_torch.ops\n"
        "import usip_tpu_torch.weights, usip_tpu_torch.ablate\n"
        "import usip_tpu_torch.train, usip_tpu_torch.losses\n"
        "import usip_tpu_torch.data.augment\n"
        "bad = [m for m in sys.modules\n"
        "       if m == 'usip_tpu' or m.startswith('usip_tpu.')\n"
        "       or m == 'jax' or m.startswith('jax.')]\n"
        "assert 'usip_tpu_torch.inference' in sys.modules\n"
        "assert 'usip_tpu_torch.train.steps' in sys.modules\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
