"""The port's training engine (``usip_tpu_torch.train.loop``) and its
``train-detector`` command, on the CPU at a tiny width.

* Two epochs of ``--synthetic`` through ``cli.main([..., "--device",
  "cpu"])`` write ``config.json``, the metrics stream and the ``best`` and
  ``last`` checkpoints with finite losses; ``--resume auto`` starts at the
  next epoch.
* The engine's LR and BatchNorm momentum by epoch equal usip_tpu's
  schedules; ``maybe_save`` and the sample cadence (``fit_samples``)
  decide as usip_tpu's engine does on the same metric sequences (both
  engines driven by stub steps); five non-finite losses in a row raise
  ``FloatingPointError``; ``resume`` restores the epoch, the best test loss
  and the sample counters.
* The entry points raise without CUDA under their default ``--device
  cuda``.
"""

import json
import math
import os
import types

import jax
import numpy as np
import pytest
import torch

import usip_tpu.train.loop as jloop
from usip_tpu.nn.layers import bn_momentum_schedule as jax_bn_schedule
from usip_tpu.train.state import lr_at_epoch as jax_lr_at_epoch
from usip_tpu.utils.logging import MetricsLogger as JaxMetricsLogger
from usip_tpu.utils.logging import Throughput as JaxThroughput
from usip_tpu_torch import bench, cli, quality
from usip_tpu_torch.config import get_config
from usip_tpu_torch.nn.layers import BatchNorm
from usip_tpu_torch.train import loop
from usip_tpu_torch.train.checkpoint import save_checkpoint

torch.set_num_threads(1)

TINY = {"data.input_pc_num": 128, "data.node_num": 16, "detector.c1": 16,
        "detector.c2": 64, "detector.node_knn_k": 4, "train.log_every": 3}


def _flags(overrides):
    out = []
    for k, v in overrides.items():
        out += ["--override", f"{k}={json.dumps(v)}"]
    return out


def _train_cli(tmp_path, *extra):
    cli.main(["train-detector", "--dataset", "modelnet", "--synthetic",
              "--batch-size", "8", "--name", "t", "--checkpoints-dir",
              str(tmp_path), "--device", "cpu", *_flags(TINY), *extra])


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_train_detector_cli_two_epochs_then_resume(tmp_path, capsys):
    """Files written, losses finite, sigmas shrink from their initial
    softplus(0); the resumed run starts at epoch 2 with the step count
    and checkpoints carried on."""
    _train_cli(tmp_path, "--epochs", "2")
    out = tmp_path / "t"
    for name in ("config.json", "t_metrics.jsonl", "best.pt", "best.pt.json",
                 "last.pt", "last.pt.json"):
        assert (out / name).exists(), name
    cfg = json.loads((out / "config.json").read_text())
    assert cfg["data"]["input_pc_num"] == 128 and cfg["train"]["epochs"] == 2
    recs = _records(out / "t_metrics.jsonl")
    assert {r["epoch"] for r in recs} == {0, 1}
    assert all(math.isfinite(r["loss"]) for r in recs if "loss" in r)
    epochs = [r for r in recs if r["prefix"] == "train_epoch"]
    tests = [r for r in recs if r["prefix"] == "test"]
    assert len(epochs) == len(tests) == 2
    # 64 synthetic items, batch 8: 8 steps an epoch
    assert epochs[-1]["step"] == 16
    assert epochs[-1]["sigma_mean"] < math.log(2.0)
    assert json.loads((out / "last.pt.json").read_text())["epoch"] == 1

    capsys.readouterr()
    _train_cli(tmp_path, "--epochs", "3", "--resume", "auto")
    assert f"resumed from {out / 'last.pt'} at epoch 2" in \
        capsys.readouterr().out
    new = _records(out / "t_metrics.jsonl")[len(recs):]
    assert new and {r["epoch"] for r in new} == {2}
    assert [r["step"] for r in new if r["prefix"] == "train_epoch"] == [24]
    assert json.loads((out / "last.pt.json").read_text())["epoch"] == 2
    assert torch.load(out / "last.pt", weights_only=True)["step"] == 24


class _Frames:
    """``n`` siamese items of the tiny width, made from a seed."""

    def __init__(self, n, cfg, seed=0):
        rng = np.random.default_rng(seed)
        shape = (cfg.data.input_pc_num, 3)
        self.items = [{k: rng.normal(size=shape).astype(np.float32)
                       for k in ("src_pc", "src_sn", "dst_pc", "dst_sn")}
                      for _ in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _engine(tmp_path, n=8, batch=4, **overrides):
    from usip_tpu_torch.data.pipeline import BatchLoader
    cfg = get_config("modelnet", **{**TINY, "train.batch_size": batch,
                                    "train.checkpoint_dir": str(tmp_path),
                                    **overrides})
    loader = BatchLoader(_Frames(n, cfg), batch, shuffle=False,
                         num_workers=1)
    return loop.DetectorEngine(cfg, loader, loader, device="cpu")


def test_lr_and_bn_momentum_by_epoch_equal_usip_tpu(tmp_path):
    """Over 9 epochs with decays every 2: the optimizer's LR in each epoch
    and the momentum the step sets on every BatchNorm equal usip_tpu's
    lr_at_epoch and bn_momentum_schedule."""
    eng = _engine(tmp_path, **{"train.lr_decay_step": 2,
                               "train.lr_decay_ratio": 0.5,
                               "train.lr_clip": 1e-4,
                               "train.bn_momentum_decay_step": 2,
                               "train.bn_momentum_decay": 0.5})
    t = eng.cfg.train
    real_step, seen = eng.train_step, []

    def step(state, batch, epoch, *, generator=None):
        metrics = real_step(state, batch, epoch, generator=generator)
        moms = {m.momentum for m in state.model.modules()
                if isinstance(m, BatchNorm)}
        seen.append((epoch, state.optimizer.param_groups[0]["lr"], moms))
        return metrics

    eng.train_step = step
    for epoch in range(9):
        eng.train_epoch(epoch)
    assert [e for e, _, _ in seen] == [e for e in range(9) for _ in range(2)]
    for epoch, lr, moms in seen:
        assert lr == jax_lr_at_epoch(t.lr, epoch, t.lr_decay_step,
                                     t.lr_decay_ratio, t.lr_clip)
        ref = float(jax_bn_schedule(t.bn_momentum, epoch,
                                    t.bn_momentum_decay_step,
                                    t.bn_momentum_decay))
        assert len(moms) == 1 and abs(moms.pop() - ref) <= 1e-7 * ref
    assert seen[-1][1] == 1e-4  # the clip


def _stub_jax_engine(tmp_path, cfg_dict, loader, steps_losses, sweeps,
                     monkeypatch):
    """usip_tpu's DetectorEngine without a model: stub steps and sweeps,
    saves and LR changes recorded."""
    from usip_tpu.config import Config as JaxConfig
    eng = object.__new__(jloop.DetectorEngine)
    eng.cfg = JaxConfig.from_json(json.dumps(cfg_dict))
    eng.train_loader = eng.test_loader = loader
    eng.out_dir = str(tmp_path / "ref")
    eng.logger = JaxMetricsLogger(eng.out_dir, "ref")
    eng.throughput = JaxThroughput(1)
    eng.best_test_loss = float("inf")
    eng._key = jax.random.PRNGKey(1)
    eng.start_epoch, eng.max_nonfinite, eng._nonfinite_streak = 0, 5, 0
    eng._fit_samples_resume = None
    eng.state = types.SimpleNamespace(step=0)
    eng._device_batch = lambda raw: raw
    losses = iter(steps_losses)
    eng.train_step = lambda state, *a: (state, {"loss": np.float32(
        next(losses))})
    record = {"saves": [], "lr": [], "sweeps": []}

    def sweep(epoch, max_samples):
        record["sweeps"].append((epoch, max_samples))
        return {"loss": sweeps[len(record["sweeps"]) - 1]}

    eng.test_sweep_truncated = sweep
    monkeypatch.setattr(jloop, "save_checkpoint", lambda path, state,
                        metadata=None: record["saves"].append(
                            (os.path.basename(path), metadata)))

    def set_lr(state, lr):
        record["lr"].append(lr)
        return state

    monkeypatch.setattr(jloop, "set_learning_rate", set_lr)
    return eng, record


def _stub_port_engine(eng, steps_losses, sweeps, monkeypatch):
    losses = iter(steps_losses)
    eng.train_step = lambda state, *a, **k: {"loss": torch.tensor(
        float(next(losses)))}
    record = {"saves": [], "lr": [], "sweeps": []}

    def sweep(epoch, max_samples):
        record["sweeps"].append((epoch, max_samples))
        return {"loss": sweeps[len(record["sweeps"]) - 1]}

    eng.test_sweep_truncated = sweep
    monkeypatch.setattr(loop, "save_checkpoint", lambda path, state,
                        metadata=None: record["saves"].append(
                            (os.path.basename(path).replace(".pt",
                                                            ".msgpack"),
                             metadata)))
    monkeypatch.setattr(loop, "set_learning_rate", lambda opt, lr:
                        record["lr"].append(lr))
    return record


def test_fit_samples_cadence_equals_usip_tpu(tmp_path, monkeypatch):
    """match3d's sample cadence on the same losses: the truncated test
    sweeps, the LR decays, the best and last saves with their counters, and
    a resumed continuation from the last counters."""
    over = {"train.cadence": "samples", "train.test_every_samples": 12,
            "train.test_max_samples": 8, "train.lr_decay_samples": 20,
            "train.lr_decay_ratio": 0.5, "train.save_min_samples": 30,
            "train.log_every": 2}
    eng = _engine(tmp_path, n=28, **over)  # 7 steps of 4 an epoch
    sweeps = [3.0, 2.0, 2.5, 1.0, 1.0 + 5e-6, 0.5, 0.7, 0.2, 0.1, 0.3,
              0.1 + 1e-6, 0.4, 0.05, 0.06, 0.9, 0.01]
    steps = np.linspace(4.0, 1.0, 40)
    cfg_dict = json.loads(eng.cfg.to_json())
    jeng, jrec = _stub_jax_engine(tmp_path, cfg_dict, eng.train_loader,
                                  steps, sweeps, monkeypatch)
    rec = _stub_port_engine(eng, steps, sweeps, monkeypatch)
    jeng.fit_samples(3)
    eng.fit_samples(3)
    assert len(jrec["sweeps"]) == 7 and len(jrec["lr"]) == 4
    assert rec == jrec
    assert eng.best_test_loss == jeng.best_test_loss
    assert [n for n, _ in rec["saves"]].count("best.msgpack") >= 2

    # resume from the last save's counters, two more epochs
    last = rec["saves"][-1][1]
    for e in (eng, jeng):
        e.start_epoch = last["epoch"] + 1
        e._fit_samples_resume = dict(last["fit_samples"])
    for r in (rec, jrec):
        r["saves"].clear(), r["lr"].clear()
    jeng.fit_samples(5)
    eng.fit_samples(5)
    assert rec["saves"] == jrec["saves"] and rec["lr"] == jrec["lr"]
    assert rec["lr"][0] == last["fit_samples"]["lr"]


def test_maybe_save_decides_as_usip_tpu(tmp_path, monkeypatch):
    """The chamfer gate, the warm-up epoch and the best loss on the same
    metric sequences: the same saves and the same best loss."""
    saves = {"port": [], "ref": []}
    monkeypatch.setattr(loop, "save_checkpoint", lambda p, s, metadata=None:
                        saves["port"].append(metadata))
    monkeypatch.setattr(jloop, "save_checkpoint", lambda p, s, metadata=None:
                        saves["ref"].append(metadata))
    rng = np.random.default_rng(0)
    for gate, min_epoch in ((None, 0), (0.5, 0), (0.5, 4), (None, 6)):
        port = types.SimpleNamespace(best_test_loss=float("inf"),
                                     out_dir=str(tmp_path), state=None)
        ref = types.SimpleNamespace(best_test_loss=float("inf"),
                                    out_dir=str(tmp_path), state=None)
        for epoch in range(12):
            m = {"loss": float(rng.uniform(0, 2)),
                 "chamfer_pure": float(rng.uniform(0.2, 0.8))}
            if epoch == 5:
                m = {}  # no test loader: nothing is saved
            a = loop.DetectorEngine.maybe_save(port, epoch, m, gate,
                                               min_epoch)
            b = jloop.DetectorEngine.maybe_save(ref, epoch, m, gate,
                                                min_epoch)
            assert a == b and port.best_test_loss == ref.best_test_loss
    assert saves["port"] == saves["ref"] and len(saves["port"]) > 3


def test_nonfinite_losses_raise(tmp_path):
    """Four non-finite losses then a finite one reset the streak; five in a
    row raise, in the epoch cadence and in the sample cadence."""
    seq = [math.nan] * 4 + [1.0] + [math.inf] * 4 + [2.0]
    for over in ({}, {"train.cadence": "samples"}):
        eng = _engine(tmp_path, n=40, **{"train.log_every": 1, **over})
        losses = iter(seq)
        eng.train_step = lambda *a, **k: {"loss": torch.tensor(next(losses))}
        eng.train_epoch(0) if not over else eng.fit_samples(1)
        eng.train_step = lambda *a, **k: {"loss": torch.tensor(math.nan)}
        with pytest.raises(FloatingPointError, match="5 consecutive"):
            eng.train_epoch(1) if not over else eng.fit_samples(2)


def test_resume_restores_epoch_best_loss_and_counters(tmp_path):
    a = _engine(tmp_path / "a")
    counters = {"total": 48.0, "next_test": 60.0, "next_lr": 80.0,
                "lr": 5e-4, "best_test_loss": 0.25}
    path = str(tmp_path / "a" / "last.pt")
    save_checkpoint(path, a.state, metadata={"epoch": 3, "loss": 0.75,
                                             "fit_samples": counters})
    b = _engine(tmp_path / "b")
    assert b.resume(path) == 4
    assert b.start_epoch == 4 and b.best_test_loss == 0.25
    assert b._fit_samples_resume == counters
    save_checkpoint(path, a.state, metadata={"epoch": 6, "loss": 0.75})
    c = _engine(tmp_path / "c")
    assert c.resume(path) == 7 and c.best_test_loss == 0.75
    assert c._fit_samples_resume is None


def test_stream_seeds_are_fixed_and_distinct():
    seeds = {loop.stream_seed(1, r, c) for r in range(4) for c in range(50)}
    assert len(seeds) == 200
    assert loop.stream_seed(1, 0, 7) == loop.stream_seed(1, 0, 7)
    g = loop.stream_generator("cpu", 1, 0, 7)
    assert torch.equal(torch.rand(4, generator=g), torch.rand(
        4, generator=loop.stream_generator("cpu", 1, 0, 7)))


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without CUDA")
def test_entry_points_raise_without_cuda(tmp_path):
    """Under the default ``--device cuda`` each entry point raises rather
    than run on the CPU."""
    tiny = _flags({"data.input_pc_num": 128})
    calls = [
        lambda: cli.main(["train-detector", "--dataset", "modelnet",
                          "--synthetic", "--checkpoints-dir", str(tmp_path),
                          *tiny]),
        lambda: cli.main(["export-keypoints", "--dataset", "modelnet",
                          "--synthetic", "--checkpoint", "x.pt", "--out",
                          str(tmp_path), *tiny]),
        lambda: cli.main(["bench"]), lambda: bench.main([]),
        lambda: quality.main(["--root", str(tmp_path)]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
