"""The detector's training engine on one device (counterpart of
``usip_tpu/train/loop.py``): loader iteration with host-to-device prefetch,
the LR and BN-momentum schedules by epoch, per-epoch test sweeps with
weighted averages, the chamfer-gated ``best`` save, ``last``/``epoch_N``
saves, the abort after repeated non-finite losses, exact resume, and the
sample-count cadence (``fit_samples``).

Host syncs follow usip_tpu's discipline: metrics stay on the device during
the epoch, one fetch of the metrics every ``log_every`` steps, one stacked
fetch of the epoch's metrics at its end (``_fetch_metrics``).

Randomness: each step draws from its own ``torch.Generator`` on the device,
seeded by a fixed function of ``(train.seed, role, counter)``
(``stream_generator``), where usip_tpu folds the role and counter into a
JAX key; so a resumed run draws what an unbroken run would. The draws never
equal JAX's.

Not ported: the multi-device mesh branch (``train.num_devices > 1``) and
the PNG render of ``snapshot_visuals`` (its ``.npz`` payload is written).
"""

from __future__ import annotations

import os
import queue as queue_mod
import threading
from typing import Dict, Optional

import numpy as np
import torch

from usip_tpu_torch.config import Config
from usip_tpu_torch.inference import resolve_device
from usip_tpu_torch.models import Detector
from usip_tpu_torch.ops import sample_nodes
from usip_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from usip_tpu_torch.train.state import (TrainState, lr_at_epoch,
                                        set_learning_rate)
from usip_tpu_torch.train.steps import (DetectorBatch, ParentBatch,
                                        make_detector_eval_step,
                                        make_detector_train_step)
from usip_tpu_torch.utils.logging import (MetricsLogger, RunningAverages,
                                          Throughput)

# the streams of draws: train steps, test sweeps, truncated test sweeps,
# snapshots (usip_tpu's roles 0-3)
ROLE_TRAIN, ROLE_TEST, ROLE_SWEEP, ROLE_SNAPSHOT = 0, 1, 2, 3


def stream_seed(seed: int, role: int, counter: int) -> int:
    """A 63-bit seed that is a fixed function of ``(seed, role, counter)``;
    distinct roles never share a stream."""
    words = np.random.SeedSequence([seed, role, counter]).generate_state(
        2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def stream_generator(device, seed: int, role: int, counter: int
                     ) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, role, counter))


def prefetch_batches(loader, device_batch_fn, depth: int = 8):
    """Yield ``(device_batch, host_batch_size)`` with the host-to-device
    copies issued from a background thread, ``depth`` batches ahead of the
    consumer."""
    q: "queue_mod.Queue" = queue_mod.Queue(maxsize=depth)
    sentinel = object()
    err = []
    stop = threading.Event()

    def _put(item) -> bool:
        # bounded put that gives up when the consumer abandoned the generator
        # (truncated test sweeps, snapshot_visuals' single-batch pull),
        # otherwise the producer blocks forever holding device batches
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue_mod.Full:
                continue
        return False

    def producer():
        try:
            for raw in loader:
                if stop.is_set():
                    break
                for key in ("pc", "src_pc", "anc_pc"):
                    if key in raw:
                        bsz = raw[key].shape[0]
                        break
                else:
                    bsz = next(iter(raw.values())).shape[0]
                if not _put((device_batch_fn(raw), bsz)):
                    break
        except BaseException as e:  # surface loader errors in the consumer
            err.append(e)
        finally:
            _put(sentinel)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
    finally:
        stop.set()
        # drain so a blocked producer can observe the stop flag promptly
        try:
            while True:
                q.get_nowait()
        except queue_mod.Empty:
            pass
        t.join(timeout=30)
    if err:
        raise err[0]


def _fetch_metrics(pending):
    """A list of (device metric dict, weight) on the host with one
    device-to-host copy for all of them."""
    if not pending:
        return []
    keys = list(pending[0][0].keys())
    table = torch.stack([torch.stack([m[k].float() for m, _ in pending])
                         for k in keys]).cpu().numpy()  # (K, steps)
    return [({k: float(table[j, i]) for j, k in enumerate(keys)}, w)
            for i, (_, w) in enumerate(pending)]


def init_detector_state(cfg: Config, seed: int = 0, device="cpu"
                        ) -> TrainState:
    """A freshly initialised detector (its initialisers drawing from
    ``seed``, the global torch RNG left as it was) and its Adam, on
    ``device``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = Detector(cfg.detector)
    return TrainState.create(model.to(device), cfg.train.lr)


class DetectorEngine:
    """End-to-end detector training (the reference's train_detector.py
    loops) on one device."""

    def __init__(self, cfg: Config, train_loader, test_loader=None,
                 out_dir: Optional[str] = None,
                 profile_dir: Optional[str] = None, device="cuda"):
        if cfg.train.num_devices > 1:
            raise NotImplementedError(
                "train.num_devices > 1 (the device mesh) is not ported; "
                "the engine trains on one device")
        self.cfg = cfg
        self.device = resolve_device(device)
        # full fp32 products on the card: TF32 keeps about three decimal
        # digits, and the fp32 checks need all of them
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # torch.profiler trace of one steady-state step
        self.profile_dir = profile_dir
        self.train_loader = train_loader
        self.test_loader = test_loader
        self.out_dir = out_dir or os.path.join(cfg.train.checkpoint_dir,
                                               cfg.train.name)
        os.makedirs(self.out_dir, exist_ok=True)
        with open(os.path.join(self.out_dir, "config.json"), "w") as f:
            f.write(cfg.to_json())

        self.state = init_detector_state(cfg, cfg.train.seed, self.device)
        self.train_step = make_detector_train_step(cfg)
        self.eval_step = make_detector_eval_step(cfg)
        self.logger = MetricsLogger(self.out_dir, cfg.train.name)
        self.throughput = Throughput()
        self.best_test_loss = float("inf")
        self._seed = cfg.train.seed + 1
        self.start_epoch = 0
        # abort with a clear error after consecutive non-finite losses
        # instead of silently training on garbage
        self.max_nonfinite = 5
        self._nonfinite_streak = 0
        # sample-cadence counters restored by resume() (fit_samples)
        self._fit_samples_resume: Optional[Dict[str, float]] = None

    def resume(self, path: str) -> int:
        """Exact resume from a full-state checkpoint: parameters, BatchNorm
        statistics, optimizer and step; the epoch, best test loss and
        sample counters from the metadata sidecar. A usip_tpu ``.msgpack``
        restores all but the optimizer (``train/checkpoint.py``)."""
        meta = restore_checkpoint(path, self.state)
        if meta and "epoch" in meta:
            self.start_epoch = int(meta["epoch"]) + 1
        if meta and "loss" in meta:
            self.best_test_loss = float(meta["loss"])
        if meta and "fit_samples" in meta:
            # sample-cadence counters (total/next_test/next_lr/lr) so the
            # match3d-style LR schedule and test/save cadence continue
            self._fit_samples_resume = {k: float(v) for k, v
                                        in meta["fit_samples"].items()}
            if "best_test_loss" in self._fit_samples_resume:
                self.best_test_loss = self._fit_samples_resume["best_test_loss"]
        return self.start_epoch

    def _device_batch(self, raw: Dict[str, np.ndarray]):
        """The host batch on the device: rounded to the wire dtype on the
        host (as usip_tpu does), copied from pinned memory without blocking
        on the current (default) stream, which the steps run on."""
        wire = self.cfg.data.wire_dtype
        if wire not in ("float32", "float16"):
            raise NotImplementedError(
                f"data.wire_dtype {wire!r} is not ported (float32 | "
                "float16; quant and float16_packed were a TPU transfer "
                "format)")
        dtype = np.float16 if wire == "float16" else np.float32

        def put(a):
            t = torch.from_numpy(np.ascontiguousarray(a, dtype))
            if self.device.type != "cuda":
                return t.to(self.device)
            return t.pin_memory().to(self.device, non_blocking=True)

        if "pc" in raw:  # parent-cloud wire mode (data.device_sampling)
            return ParentBatch(pc=put(raw["pc"]), sn=put(raw["sn"]))
        return DetectorBatch(src_pc=put(raw["src_pc"]),
                             src_sn=put(raw["src_sn"]),
                             dst_pc=put(raw["dst_pc"]),
                             dst_sn=put(raw["dst_sn"]))

    def _prefetch(self, loader, depth: int = 8):
        return prefetch_batches(loader, self._device_batch, depth)

    def _generator(self, role: int, counter: int) -> torch.Generator:
        return stream_generator(self.device, self._seed, role, counter)

    def _log_interval(self, metrics, epoch: int, extra: Dict[str, float],
                      what: str) -> None:
        """The periodic log line (one fetch of the step's metrics) and the
        non-finite guard."""
        host = _fetch_metrics([(metrics, 1)])[0][0]
        if not np.isfinite(host["loss"]):
            self._nonfinite_streak += 1
            self.logger.log(self.state.step, epoch, {"nonfinite_loss": 1.0},
                            prefix="warn")
            if self._nonfinite_streak >= self.max_nonfinite:
                raise FloatingPointError(
                    f"{self.max_nonfinite} consecutive non-finite losses in "
                    f"{what}, at step {self.state.step}: aborting (restore "
                    "the last checkpoint, lower the LR)")
        else:
            self._nonfinite_streak = 0
        host.update(extra)
        host["clouds_per_sec_per_chip"] = self.throughput.rate()
        self.logger.log(self.state.step, epoch, host, prefix="train")

    def _step(self, batch, epoch: int, i: int):
        gen = self._generator(ROLE_TRAIN, self.cfg.train.seed
                              + 1_000_000 * epoch + i)
        return self.train_step(self.state, batch, epoch, generator=gen)

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        cfg = self.cfg
        # epoch-level LR schedule (the reference updates at epoch boundaries)
        lr = lr_at_epoch(cfg.train.lr, epoch, cfg.train.lr_decay_step,
                         cfg.train.lr_decay_ratio, cfg.train.lr_clip)
        set_learning_rate(self.state.optimizer, lr)
        averages = RunningAverages()
        self.throughput.reset()
        pending = []  # (device metrics, weight), fetched at the epoch's end
        for i, (batch, batch_size) in enumerate(self._prefetch(self.train_loader)):
            if self.profile_dir is not None and epoch == 0 and i == 10:
                metrics = self._profiled_step(batch, epoch, i)
            else:
                metrics = self._step(batch, epoch, i)
            pending.append((metrics, batch_size))
            # a siamese step puts 2 clouds through the model per batch item
            self.throughput.add(batch_size * 2)
            if i % cfg.train.log_every == 0:
                self._log_interval(metrics, epoch, {"lr": lr}, "train_epoch")
        for host_metrics, weight in _fetch_metrics(pending):
            averages.update(host_metrics, weight=weight)
        return averages.averages()

    def _profiled_step(self, batch, epoch: int, i: int):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            metrics = self._step(batch, epoch, i)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        os.makedirs(self.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.profile_dir,
                                              f"train_step_{i}.json"))
        return metrics

    def _sweep(self, role: int, epoch: int,
               max_samples: Optional[int] = None) -> Dict[str, float]:
        if self.test_loader is None:
            return {}
        averages = RunningAverages()
        pending = []
        tested = 0
        for i, (batch, batch_size) in enumerate(self._prefetch(self.test_loader)):
            metrics = self.eval_step(self.state, batch,
                                     generator=self._generator(role, i))
            pending.append((metrics, batch_size))
            tested += batch_size
            if max_samples is not None and tested > max_samples:
                break
        for host_metrics, weight in _fetch_metrics(pending):
            averages.update(host_metrics, weight=weight)
        avg = averages.averages()
        if avg:
            self.logger.log(self.state.step, epoch, avg, prefix="test")
        return avg

    def test_epoch(self, epoch: int) -> Dict[str, float]:
        return self._sweep(ROLE_TEST, epoch)

    def test_sweep_truncated(self, epoch: int, max_samples: int) -> Dict[str, float]:
        """Sample-cadence test sweep, truncated like match3d's 'break at >2000
        tested samples' (train_detector.py:144-145)."""
        return self._sweep(ROLE_SWEEP, epoch, max_samples)

    def maybe_save(self, epoch: int, test_metrics: Dict[str, float],
                   chamfer_gate: Optional[float] = None,
                   min_epoch: int = 0) -> bool:
        """Quality-gated best-checkpoint save (kitti/train_detector.py:148-150:
        best loss AND chamfer_pure below gate AND epoch past warmup)."""
        loss = test_metrics.get("loss", float("inf"))
        improved = loss < self.best_test_loss
        if improved:
            self.best_test_loss = loss
        gate_ok = (chamfer_gate is None
                   or test_metrics.get("chamfer_pure", float("inf")) < chamfer_gate)
        if improved and gate_ok and epoch >= min_epoch:
            save_checkpoint(os.path.join(self.out_dir, "best.pt"), self.state,
                            metadata={"epoch": epoch, **test_metrics})
            return True
        return False

    @torch.no_grad()
    def snapshot_visuals(self, epoch: int) -> Optional[str]:
        """Keypoint-scene snapshot during training (the visdom
        display_current_results analog, keypoint_detector.py:259-334): the
        cloud, nodes, keypoints and sigmas of one test (or train) cloud as
        ``.npz``, from the eval forward on the nodes it shows."""
        loader = self.test_loader or self.train_loader
        try:
            raw = next(iter(loader))
        except StopIteration:
            return None
        pc_np = raw["pc"] if "pc" in raw else raw["src_pc"]
        sn_np = raw["sn"] if "sn" in raw else raw["src_sn"]
        n = self.cfg.data.input_pc_num
        if pc_np.shape[1] > n:  # parent-cloud wire mode
            sel = np.random.default_rng(epoch).choice(pc_np.shape[1], n,
                                                      replace=False)
            pc_np, sn_np = pc_np[:, sel], sn_np[:, sel]
        pc = torch.as_tensor(pc_np[:1], dtype=torch.float32, device=self.device)
        sn = torch.as_tensor(sn_np[:1], dtype=torch.float32, device=self.device)
        data = self.cfg.data
        nodes = sample_nodes(pc, data.node_num,
                             data.eval_fps_subsample_ratio
                             or data.fps_subsample_ratio, data.fps_parallel,
                             generator=self._generator(ROLE_SNAPSHOT, epoch))
        model = self.state.model
        model.eval()
        _, kp, sig = model(pc, sn, nodes)
        arrays = {"pc": pc[0], "nodes": nodes[0], "keypoints": kp[0],
                  "sigmas": sig[0]}
        return self.logger.snapshot_clouds(
            "scene", self.state.step,
            **{k: v.cpu().numpy() for k, v in arrays.items()})

    def fit(self, epochs: Optional[int] = None,
            chamfer_gate: Optional[float] = None, min_epoch: int = 0):
        if self.cfg.train.cadence == "samples":
            return self.fit_samples(epochs)
        tcfg = self.cfg.train
        epochs = epochs or tcfg.epochs
        for epoch in range(self.start_epoch, epochs):
            train_avg = self.train_epoch(epoch)
            self.logger.log(self.state.step, epoch, train_avg,
                            prefix="train_epoch")
            test_avg = self.test_epoch(epoch)
            self.maybe_save(epoch, test_avg, chamfer_gate, min_epoch)
            if tcfg.vis_every_epochs and epoch % tcfg.vis_every_epochs == 0:
                self.snapshot_visuals(epoch)
            if tcfg.save_every_epochs and epoch % tcfg.save_every_epochs == 0:
                meta = {"epoch": epoch, **test_avg}
                save_checkpoint(os.path.join(self.out_dir, "last.pt"),
                                self.state, metadata=meta)
                if tcfg.keep_epoch_checkpoints:
                    # the reference's per-epoch trail ('<epoch>_net_
                    # detector.pth', modelnet train_detector.py:111-113)
                    save_checkpoint(
                        os.path.join(self.out_dir, f"epoch_{epoch}.pt"),
                        self.state, metadata=meta)
        return self.state

    def fit_samples(self, epochs: Optional[int] = None):
        """Sample-count cadence (match3d/train_detector.py:71-80,144-173):
        test sweep every test_every_samples (truncated), LR x ratio every
        lr_decay_samples, best-loss saves only past save_min_samples.

        The sample counters (total/lr/cadence) go into the metadata sidecar
        of each epoch-end ``last.pt``, so ``resume()`` continues the LR
        schedule and the test/save cadence exactly."""
        tcfg = self.cfg.train
        epochs = epochs or tcfg.epochs
        total = 0
        next_test = tcfg.test_every_samples
        next_lr = tcfg.lr_decay_samples
        lr = tcfg.lr
        if self._fit_samples_resume is not None:
            rs = self._fit_samples_resume
            total = int(rs.get("total", total))
            next_test = int(rs.get("next_test", next_test))
            next_lr = int(rs.get("next_lr", next_lr))
            lr = float(rs.get("lr", lr))
            set_learning_rate(self.state.optimizer, lr)
        for epoch in range(self.start_epoch, epochs):
            pending = []
            averages = RunningAverages()
            self.throughput.reset()
            for i, (batch, batch_size) in enumerate(
                    self._prefetch(self.train_loader)):
                metrics = self._step(batch, epoch, i)
                pending.append((metrics, batch_size))
                total += batch_size
                self.throughput.add(batch_size * 2)
                if i % tcfg.log_every == 0:
                    self._log_interval(metrics, epoch,
                                       {"lr": lr,
                                        "total_samples": float(total)},
                                       "fit_samples")
                if total >= next_test:
                    next_test += tcfg.test_every_samples
                    test_avg = self.test_sweep_truncated(
                        epoch, tcfg.test_max_samples)
                    if test_avg:
                        # match3d:152-163: track best loss; save when at/near
                        # best AND past the warmup sample budget
                        loss = test_avg.get("loss", float("inf"))
                        self.best_test_loss = min(self.best_test_loss, loss)
                        if (loss <= self.best_test_loss + 1e-5
                                and total > tcfg.save_min_samples):
                            save_checkpoint(
                                os.path.join(self.out_dir, "best.pt"),
                                self.state,
                                metadata={"epoch": epoch,
                                          "total_samples": total,
                                          "fit_samples": self._counters(
                                              total, next_test, next_lr, lr),
                                          **test_avg})
                if total >= next_lr:
                    next_lr += tcfg.lr_decay_samples
                    lr = max(lr * tcfg.lr_decay_ratio, tcfg.lr_clip)
                    set_learning_rate(self.state.optimizer, lr)
            for host_metrics, weight in _fetch_metrics(pending):
                averages.update(host_metrics, weight=weight)
            self.logger.log(self.state.step, epoch, averages.averages(),
                            prefix="train_epoch")
            # epoch-end resume point carrying the sample counters
            save_checkpoint(
                os.path.join(self.out_dir, "last.pt"), self.state,
                metadata={"epoch": epoch,
                          "fit_samples": self._counters(total, next_test,
                                                        next_lr, lr)})
        return self.state

    def _counters(self, total: int, next_test: int, next_lr: int,
                  lr: float) -> Dict[str, float]:
        return {"total": total, "next_test": next_test, "next_lr": next_lr,
                "lr": lr, "best_test_loss": self.best_test_loss}
