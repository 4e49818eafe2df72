"""The engine's transfers and the export on the card, against the CPU.

Card-only (the ``cuda`` marker; they skip elsewhere). On a GPU host, where
jax is absent, run them without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_train.py -q

* ``DetectorEngine``'s host-to-device copies (fp16 rounding on the host,
  pinned memory, non-blocking on the default stream, issued from the
  prefetch thread) arrive bit for bit;
* one tiny engine epoch on the card trains (finite metrics, saved
  checkpoints that restore on the CPU);
* the model export on the card, with the same node draws, writes what the
  CPU writes: the same frames and keypoint counts, each keypoint within the
  fused chain's bf16 tolerance of the on-card slice check (max 2e-2, median
  2e-3 of max|CPU|) of the nearest keypoint on the other side.
"""

import os

import numpy as np
import pytest
import torch

from usip_tpu_torch.config import get_config
from usip_tpu_torch.data.pipeline import BatchLoader
from usip_tpu_torch.eval import export_runner
from usip_tpu_torch.eval.export import read_keypoints_bin
from usip_tpu_torch.train.checkpoint import restore_checkpoint
from usip_tpu_torch.train.loop import (DetectorEngine, init_detector_state,
                                       prefetch_batches)

pytestmark = pytest.mark.cuda

TINY = {"data.input_pc_num": 512, "data.parent_pc_num": 640,
        "data.node_num": 32, "detector.c1": 32, "detector.c2": 64,
        "detector.node_knn_k": 8, "train.batch_size": 4,
        "train.log_every": 1}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU build")
    return torch.device("cuda")


class _Parents:
    def __init__(self, n, p, seed=0):
        rng = np.random.default_rng(seed)
        self.items = [{"pc": rng.normal(0, 20, (p, 3)).astype(np.float32),
                       "sn": rng.normal(size=(p, 4)).astype(np.float32)}
                      for _ in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


class _Frames:
    def __init__(self, n, points, seed=1):
        rng = np.random.default_rng(seed)
        self.items = [{"pc": rng.normal(0, 20, (points, 3)).astype(np.float32),
                       "sn": rng.normal(size=(points, 4)).astype(np.float32),
                       "seq": np.int64(0), "frame": np.int64(i)}
                      for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _engine(tmp_path, n=16):
    cfg = get_config("kitti", **{**TINY,
                                 "train.checkpoint_dir": str(tmp_path)})
    loader = BatchLoader(_Parents(n, cfg.data.parent_pc_num), 4,
                         shuffle=False, num_workers=2)
    return cfg, loader, DetectorEngine(cfg, loader, loader, device="cuda")


def test_engine_transfers_arrive_bit_for_bit(dev, tmp_path):
    cfg, loader, eng = _engine(tmp_path)
    assert cfg.data.wire_dtype == "float16"
    got = [(b.pc.cpu(), b.sn.cpu(), n) for b, n in
           prefetch_batches(loader, eng._device_batch, depth=2)]
    want = list(loader)
    assert len(got) == len(want) == 4
    for (pc, sn, n), raw in zip(got, want):
        assert n == 4 and pc.dtype == torch.float16
        assert np.array_equal(pc.numpy(), raw["pc"].astype(np.float16))
        assert np.array_equal(sn.numpy(), raw["sn"].astype(np.float16))


def test_engine_epoch_on_the_card(dev, tmp_path):
    cfg, _, eng = _engine(tmp_path)
    state = eng.fit(2)
    assert state.step == 8
    ckpt = os.path.join(eng.out_dir, "last.pt")
    restored = init_detector_state(cfg, seed=3)
    assert restore_checkpoint(ckpt, restored)["epoch"] == 1
    for k, v in restored.model.state_dict().items():
        assert torch.equal(v, eng.state.model.state_dict()[k].cpu()), k


def test_model_export_on_the_card_matches_cpu(dev, tmp_path):
    cfg, _, eng = _engine(tmp_path)
    eng.fit(1)
    ckpt = os.path.join(eng.out_dir, "last.pt")
    ds = _Frames(7, cfg.data.input_pc_num)
    n, m = cfg.data.input_pc_num, cfg.data.node_num
    sub = n // cfg.data.fps_subsample_ratio

    def draws(i):
        g = torch.Generator().manual_seed(i)
        return (torch.stack([torch.randperm(n, generator=g)[:sub]
                             for _ in range(4)]),
                torch.randint(0, sub, (4,), generator=g))

    outs = {}
    for device in ("cuda", "cpu"):
        outs[device] = str(tmp_path / device)
        stats = export_runner.run_export(cfg, ckpt, outs[device],
                                         desired_num=m, dataset=ds,
                                         batch_size=4, device=device,
                                         node_draws=draws)
        assert stats["frames"] == 7
    for f in sorted(os.listdir(os.path.join(outs["cpu"], "00"))):
        ref = read_keypoints_bin(os.path.join(outs["cpu"], "00", f))
        got = read_keypoints_bin(os.path.join(outs["cuda"], "00", f))
        assert got.shape == ref.shape == (m, 3)
        # as sets: near-equal sigmas may order two keypoints either way
        d = np.linalg.norm(got[:, None] - ref[None], axis=-1)
        err = np.concatenate([d.min(1), d.min(0)])
        scale = np.abs(ref).max()
        assert err.max() <= 2e-2 * scale and np.median(err) <= 2e-3 * scale
