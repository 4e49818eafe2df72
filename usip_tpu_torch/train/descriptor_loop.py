"""The descriptor's training engine on one device (counterpart of
``usip_tpu/train/descriptor_loop.py``): the frozen detector restored from
its checkpoint, keypoints from it, descriptor triplet training (the
reference's oxford/kitti/scenenn train_descriptor.py, unified), the per-epoch
test sweep, the ``best`` save by ``train.select_best_by`` (test loss, or the
CGF path's matching accuracy), ``last``/``epoch_N`` saves, the abort after
repeated non-finite losses, and exact resume.

Seeds as usip_tpu's: the detector's initialisers from ``train.seed``, the
descriptor's from ``train.seed + 7``, the steps' draws from ``train.seed +
13`` (``loop.stream_generator``, one generator a step), the fallback
negatives from ``train.seed + 21``.

On one card the train step's device part replays as a CUDA graph (the
step's own choice, ``device.StepGraph``), and one prefetch of the train
batches runs from epoch to epoch (``_train_pass``), so that neither the
host's launches nor a loader starting anew each epoch hold the card back.

Data parallelism (``train.num_devices > 1``) as in ``loop.py``: each rank's
loader yields its rows, and the negatives index the global batch: the
miner runs on every rank over the global batch's metadata (gathered from
the ranks, between steps, on the main thread), the fallback permutation is
drawn for the global batch from the same seed on every rank.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from usip_tpu_torch.config import Config
from usip_tpu_torch.data.pipeline import BatchLoader
from usip_tpu_torch.device import resolve_device
from usip_tpu_torch.models import Descriptor
from usip_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from usip_tpu_torch.parallel.mesh import (all_gather_object,
                                          broadcast_object, is_main_process)
from usip_tpu_torch.train.loop import (ROLE_TEST, ROLE_TRAIN, _fetch_metrics,
                                       engine_mesh, init_detector_state,
                                       prefetch_batches, stream_generator)
from usip_tpu_torch.train.state import (TrainState, lr_at_epoch,
                                        set_learning_rate)
from usip_tpu_torch.train.steps import (PackedPairBatch,
                                        make_descriptor_train_step,
                                        pack_pair_batch)
from usip_tpu_torch.utils.logging import (MetricsLogger, RunningAverages,
                                          Throughput)


def init_descriptor_state(cfg: Config, seed: int = 0, device="cpu"
                          ) -> TrainState:
    """A freshly initialised descriptor (its initialisers drawing from
    ``seed``, the global torch RNG left as it was) and its Adam, on
    ``device``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = Descriptor(cfg.descriptor)
    return TrainState.create(model.to(device), cfg.train.lr)


class _SyntheticPairDataset:
    """Synthetic anchor/positive pairs for smoke runs: two samplings of the
    same shape; the negatives are other batch entries."""

    def __init__(self, cfg: Config, size: int = 32, seed: int = 0):
        from usip_tpu_torch.data.synthetic import SyntheticDataset
        self.base = SyntheticDataset(
            size=size, input_pc_num=cfg.data.input_pc_num,
            surface_normal_len=cfg.descriptor.surface_normal_len, seed=seed)

    def __len__(self):
        return len(self.base)

    def __getitem__(self, index):
        item = self.base[index]
        return {"anc_pc": item["src_pc"], "anc_sn": item["src_sn"],
                "pos_pc": item["dst_pc"], "pos_sn": item["dst_sn"],
                "index": np.int64(index)}


_PASS_END = "_pass_end"


class _Passes:
    """A loader's batches pass after pass, each pass closed by a marker
    batch ``{_PASS_END: empty}`` (a batch of 0 items to
    ``prefetch_batches``)."""

    def __init__(self, loader):
        self.loader = loader

    def __iter__(self):
        while True:
            yield from self.loader
            yield {_PASS_END: np.zeros(0)}


class DescriptorEngine:
    """Descriptor training on one device, or data-parallel over the ranks
    of ``train.num_devices`` (the reference's train_descriptor.py
    loops)."""

    def __init__(self, cfg: Config, detector_checkpoint: str,
                 train_loader=None, test_loader=None, mine_negatives=None,
                 use_cgf: Optional[bool] = None, synthetic: bool = False,
                 out_dir: Optional[str] = None, device="cuda"):
        self.cfg = cfg
        self.mesh = engine_mesh(cfg, device)
        self.device = (self.mesh.device if self.mesh is not None
                       else resolve_device(device))
        self._ranks = 1 if self.mesh is None else self.mesh.size
        # full fp32 products on the card (the descriptor distances included)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.out_dir = out_dir or os.path.join(cfg.train.checkpoint_dir,
                                               cfg.train.name + "_descriptor")
        if use_cgf is None:
            use_cgf = cfg.descriptor.use_cgf_loss
        if use_cgf is None:
            use_cgf = cfg.descriptor.use_global_context  # indoor pipeline
        self.use_cgf = use_cgf
        self.select_best_by = cfg.train.select_best_by
        if self.select_best_by not in ("loss", "match_acc"):
            raise ValueError(
                f"train.select_best_by={self.select_best_by!r}: expected "
                "'loss' or 'match_acc'")
        if self.select_best_by == "match_acc" and not self.use_cgf:
            raise ValueError(
                "train.select_best_by='match_acc' requires the CGF objective "
                "(descriptor.use_cgf_loss=true): the matching-accuracy metric "
                "is computed under the CGF GT alignment, which the scan "
                "triplet path does not have in-step")

        # the frozen detector (the reference loads it and freezes it,
        # oxford/train_descriptor.py:70-77)
        det_state = init_detector_state(cfg, cfg.train.seed, self.device)
        restore_checkpoint(detector_checkpoint, det_state)
        self.detector = det_state.model.eval().requires_grad_(False)
        self.state = init_descriptor_state(cfg, cfg.train.seed + 7,
                                           self.device)

        if train_loader is None:
            if not synthetic:
                raise ValueError("provide train_loader or synthetic=True")
            train_loader = BatchLoader(
                _SyntheticPairDataset(cfg), cfg.train.batch_size,
                shuffle=True, num_workers=2,
                shard=(None if self.mesh is None
                       else (self.mesh.rank, self.mesh.size)))
            mine_negatives = None
        self.train_loader = train_loader
        self.test_loader = test_loader
        self.mine_negatives = mine_negatives
        if self.mesh is not None:
            from usip_tpu_torch.parallel.mesh import replicate
            replicate(self.mesh, self.state.model)
        # on one card the step's device part replays as a CUDA graph
        self.step_fn = make_descriptor_train_step(cfg, self.use_cgf,
                                                  mesh=self.mesh)
        # the same objective without the step: the reference's per-epoch
        # descriptor test sweep
        self.eval_fn = make_descriptor_train_step(cfg, self.use_cgf,
                                                  eval_only=True,
                                                  mesh=self.mesh)
        self.logger = MetricsLogger(self.out_dir, cfg.train.name + "_desc")
        self.throughput = Throughput()
        self._seed = cfg.train.seed + 13
        # seeded fallback negatives, when no miner is given
        self._np_rng = np.random.default_rng(cfg.train.seed + 21)
        self.best_test_loss = float("inf")
        self.start_epoch = 0
        # abort after consecutive non-finite losses, as DetectorEngine does
        self.max_nonfinite = 5
        self._nonfinite_streak = 0
        # the train batches' prefetch, kept from one epoch to the next
        self._train_stream = None
        self._mid_pass = False

    def resume(self, path: str) -> int:
        """Exact resume of the descriptor's state (the frozen detector comes
        from its own checkpoint); the epoch and the selection score from the
        metadata sidecar, under the criterion this engine selects by (a
        checkpoint without that metric leaves the gate open)."""
        meta = restore_checkpoint(path, self.state)
        if meta and "epoch" in meta:
            self.start_epoch = int(meta["epoch"]) + 1
        if meta:
            score = self._selection_score(
                {k: float(v) for k, v in meta.items()
                 if isinstance(v, (int, float))})
            if score != float("inf"):
                self.best_test_loss = score
        return self.start_epoch

    _CLOUDS = ("anc_pc", "anc_sn", "pos_pc", "pos_sn")

    def _device_batch(self, raw: Dict[str, np.ndarray]):
        """The host pair batch packed into one buffer in the wire dtype
        (``pack_pair_batch``) and put on the device, and the batch's other
        fields (the miner's input); the negatives come after
        (``_with_negatives``), on the main thread. A pass's end marker
        gives None."""
        if _PASS_END in raw:
            return None
        packed = pack_pair_batch(raw["anc_pc"], raw["anc_sn"], raw["pos_pc"],
                                 raw["pos_sn"], np.zeros(0, np.int32),
                                 wire=self.cfg.data.wire_dtype)
        x = torch.from_numpy(packed.x)
        if self.device.type == "cuda":
            x = x.pin_memory().to(self.device, non_blocking=True)
        else:
            x = x.to(self.device)
        meta = {k: v for k, v in raw.items() if k not in self._CLOUDS}
        return x, meta

    def _with_negatives(self, item) -> PackedPairBatch:
        """The batch with the negatives of the global batch: the miner's
        over every rank's metadata (rank 0 mines, with its dataset's draws,
        and sends the result to every rank), or a seeded shifted
        permutation."""
        x, meta = item
        b = x.shape[0] * self._ranks
        if self.mine_negatives is not None:
            if self.mesh is None:
                neg_idx = self.mine_negatives(meta)
            else:
                parts = all_gather_object(meta, self.mesh)
                neg_idx = None
                if is_main_process():
                    neg_idx = self.mine_negatives({
                        k: np.concatenate([np.asarray(p[k]) for p in parts])
                        for k in meta})
                neg_idx = broadcast_object(neg_idx, self.mesh)
        else:
            # in-batch negatives: a seeded shifted permutation
            neg_idx = ((np.arange(b) + 1 + self._np_rng.integers(0, b - 1))
                       % b if b > 1 else np.zeros(b, np.int64))
        neg = torch.as_tensor(np.asarray(neg_idx), dtype=torch.long)
        if self.device.type == "cuda":
            # queued from pinned memory: the host does not wait for the
            # device's earlier steps
            neg = neg.pin_memory().to(self.device, non_blocking=True)
        return PackedPairBatch(x, neg.to(self.device))

    def _generator(self, role: int, counter: int) -> torch.Generator:
        return stream_generator(self.device, self._seed, role, counter)

    def _train_pass(self):
        """One pass of the train loader as ``(device batch, size)``. The
        prefetch runs on into the next pass while this one's last steps
        run, so an epoch starts on batches already on the device; the
        batches and their draws are those of one prefetch a pass, in the
        same order. Where the last pass was left before its end, the
        prefetch starts anew."""
        if self._mid_pass:
            self.close()
        if self._train_stream is None:
            self._train_stream = prefetch_batches(_Passes(self.train_loader),
                                                  self._device_batch)
        self._mid_pass = True
        for item, batch_size in self._train_stream:
            if item is None:
                self._mid_pass = False
                return
            yield item, batch_size

    def close(self) -> None:
        """Stop the train batches' prefetch (``fit`` does at its end)."""
        self._mid_pass = False
        if self._train_stream is not None:
            stream, self._train_stream = self._train_stream, None
            stream.close()

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        cfg = self.cfg
        lr = lr_at_epoch(cfg.train.lr, epoch, cfg.train.lr_decay_step,
                         cfg.train.lr_decay_ratio, cfg.train.lr_clip)
        set_learning_rate(self.state.optimizer, lr)
        averages = RunningAverages()
        self.throughput.reset()
        pending = []
        for i, (item, batch_size) in enumerate(self._train_pass()):
            batch = self._with_negatives(item)
            gen = self._generator(ROLE_TRAIN,
                                  cfg.train.seed + 1_000_000 * epoch + i)
            metrics = self.step_fn(self.state, self.detector, batch, epoch,
                                   generator=gen)
            pending.append((metrics, batch_size))
            self.throughput.add(2 * batch_size * self._ranks)
            if i % cfg.train.log_every == 0:
                host = _fetch_metrics([(metrics, 1)])[0][0]
                if not np.isfinite(host["loss"]):
                    self._nonfinite_streak += 1
                    self.logger.log(self.state.step, epoch,
                                    {"nonfinite_loss": 1.0}, prefix="warn")
                    if self._nonfinite_streak >= self.max_nonfinite:
                        raise FloatingPointError(
                            f"{self.max_nonfinite} consecutive non-finite "
                            "descriptor losses: aborting (restore the last "
                            "checkpoint, lower the LR)")
                else:
                    self._nonfinite_streak = 0
                host.update(lr=lr,
                            clouds_per_sec_per_chip=self.throughput.rate())
                self.logger.log(self.state.step, epoch, host, prefix="desc")
        for host_metrics, weight in _fetch_metrics(pending):
            averages.update(host_metrics, weight=weight)
        return averages.averages()

    def test_epoch(self, epoch: int) -> Dict[str, float]:
        if self.test_loader is None:
            return {}
        averages = RunningAverages()
        pending = []
        for i, (item, batch_size) in enumerate(
                prefetch_batches(self.test_loader, self._device_batch)):
            batch = self._with_negatives(item)
            metrics = self.eval_fn(self.state, self.detector, batch, epoch,
                                   generator=self._generator(ROLE_TEST, i))
            pending.append((metrics, batch_size))
        for host_metrics, weight in _fetch_metrics(pending):
            averages.update(host_metrics, weight=weight)
        avg = averages.averages()
        if avg:
            self.logger.log(self.state.step, epoch, avg, prefix="desc_test")
        return avg

    def _selection_score(self, metrics: Dict[str, float]) -> float:
        """The lower-is-better score of ``train.select_best_by``: the test
        loss, or the negated match_acc; an epoch without the metric scores
        +inf (it never wins)."""
        if self.select_best_by == "match_acc":
            return -metrics.get("match_acc", -float("inf"))
        return metrics.get("loss", float("inf"))

    def maybe_save(self, epoch: int, metrics: Dict[str, float]) -> bool:
        """``best.pt`` when the epoch's selection score improves on the best
        (``best_test_loss`` holds -match_acc under 'match_acc')."""
        score = self._selection_score(metrics)
        if score < self.best_test_loss:
            self.best_test_loss = score
            save_checkpoint(os.path.join(self.out_dir, "best.pt"), self.state,
                            metadata={"epoch": epoch, **metrics})
            return True
        return False

    def fit(self, epochs: Optional[int] = None):
        epochs = epochs or self.cfg.train.epochs
        try:
            return self._fit(epochs)
        finally:
            self.close()

    def _fit(self, epochs: int):
        for epoch in range(self.start_epoch, epochs):
            avg = self.train_epoch(epoch)
            self.logger.log(self.state.step, epoch, avg, prefix="desc_epoch")
            test_avg = self.test_epoch(epoch)
            # gate on the test split's metrics where there is one
            meta = {"epoch": epoch, **(test_avg or avg)}
            self.maybe_save(epoch, test_avg or avg)
            save_checkpoint(os.path.join(self.out_dir, "last.pt"), self.state,
                            metadata=meta)
            if self.cfg.train.keep_epoch_checkpoints:
                save_checkpoint(
                    os.path.join(self.out_dir, f"epoch_{epoch}.pt"),
                    self.state, metadata=meta)
        return self.state
