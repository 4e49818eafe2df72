"""The port's serving surface on the CPU: the serve/detect CLI, the refusal
to run on a missing GPU, the jax-free import, and the kernel build's error."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from usip_tpu.config import get_config
from usip_tpu_torch import _build
from usip_tpu_torch.ops import kernels
from usip_tpu_torch.weights import seeded_state_dict

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OVERRIDES = {"detector.c1": 16, "detector.c2": 32, "detector.node_knn_k": 4,
             "data.input_pc_num": 512, "data.node_num": 128}


def _override_args():
    return [a for k, v in OVERRIDES.items()
            for a in ("--override", f"{k}={v}")]


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)


@pytest.fixture
def served(tmp_path):
    """A seeded .pth checkpoint and three clouds of 600 points with 4
    normal columns."""
    cfg = get_config("kitti", **OVERRIDES)
    ckpt = tmp_path / "w.pth"
    torch.save({k: torch.tensor(v) for k, v in
                seeded_state_dict(cfg.detector, 0).items()}, ckpt)
    rng = np.random.default_rng(0)
    clouds = []
    for i in range(3):
        path = tmp_path / "in" / f"cloud{i}.npy"
        path.parent.mkdir(exist_ok=True)
        np.save(path, rng.normal(size=(600, 7)).astype(np.float32))
        clouds.append(path)
    return ckpt, clouds


def test_serve_cpu_answers_requests(served, tmp_path):
    """serve --device cpu answers 2 requests and a shutdown, writing each
    reply's .bin with num_keypoints rows."""
    ckpt, clouds = served
    out = tmp_path / "out"
    reqs = [{"id": i, "input": str(c), "out": str(out), "num_keypoints": 32}
            for i, c in enumerate(clouds[:2])] + [{"cmd": "shutdown"}]
    proc = subprocess.run(
        [sys.executable, "-m", "usip_tpu_torch.cli", "serve", "--device",
         "cpu", "--checkpoint", str(ckpt), *_override_args()],
        input="".join(json.dumps(r) + "\n" for r in reqs), text=True,
        capture_output=True, timeout=300, cwd=REPO, env=_env())
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(s) for s in proc.stdout.splitlines()]
    assert lines[0] == {"status": "ready", "descriptors": False}
    assert lines[-1] == {"status": "bye"}
    for i, reply in enumerate(lines[1:-1]):
        assert reply["id"] == i and reply["n"] == 32, reply
        kp = np.fromfile(reply["keypoints"], np.float32).reshape(-1, 3)
        assert kp.shape == (32, 3) and np.isfinite(kp).all()


def test_detect_cpu_writes_bins(served, tmp_path):
    """detect --device cpu over a directory writes one .bin per cloud."""
    ckpt, clouds = served
    out = tmp_path / "det"
    proc = subprocess.run(
        [sys.executable, "-m", "usip_tpu_torch.cli", "detect", "--device",
         "cpu", "--checkpoint", str(ckpt), "--input", str(clouds[0].parent),
         "--out", str(out), "--num-keypoints", "16", *_override_args()],
        text=True, capture_output=True, timeout=300, cwd=REPO, env=_env())
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.splitlines()[-1])["clouds"] == 3
    for c in clouds:
        kp = np.fromfile(out / f"{c.stem}.keypoints.bin", np.float32)
        assert kp.shape == (16 * 3,)


def test_pipeline_cuda_raises_without_gpu(served):
    """KeypointPipeline(device='cuda') refuses to carry on on the CPU."""
    from usip_tpu_torch.inference import KeypointPipeline

    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the refusal is for hosts without one")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        KeypointPipeline(get_config("kitti", **OVERRIDES), str(served[0]),
                         device="cuda")


def test_port_import_leaves_jax_out():
    """Importing the port's modules loads neither jax nor flax."""
    code = ("import sys, usip_tpu_torch, usip_tpu_torch.inference, "
            "usip_tpu_torch.cli, usip_tpu_torch.ops.kernels; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'flax')))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=REPO, env=_env())
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """With no nvcc anywhere the build raises a clear error and writes
    nothing."""
    monkeypatch.setattr(_build.shutil, "which", lambda *_: None)
    monkeypatch.setattr(_build.os, "access", lambda *_: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("fps", tmp_path)
    assert list(tmp_path.iterdir()) == []


def test_wrappers_refuse_non_cuda_devices():
    """A kernel wrapper runs its plain version only for CPU tensors; any
    other device that is not CUDA is refused, never computed elsewhere."""
    pts = torch.empty((1, 8, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.fps(pts, torch.zeros(1, dtype=torch.int32, device="meta"), 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.min_argmin(pts, pts)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.fusion_chain(torch.empty((1, 2, 4, 5), device="meta"),
                             [torch.empty(1)] * 6, [torch.empty(1)] * 5)
