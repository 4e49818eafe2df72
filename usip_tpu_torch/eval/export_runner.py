"""Batched keypoint export over an eval dataset (counterpart of
``usip_tpu/eval/export_runner.py``: ``make_eval_dataset :23``, ``run_export
:187``): the detector's eval forward on the device, host NMS and sigma
ranking, a ``.bin`` per frame (the reference's save_keypoints.py main loop,
:229-414).

The forward is ``models.fused_infer.detector_infer_fused`` on the restored
model (the port's serving forward: FPS, min/argmin, scatter-max, smallest-k
and the fused chain on the card). Methods ``model`` and ``random``; the ISS,
Harris and SIFT baselines are not ported.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from usip_tpu_torch.config import Config
from usip_tpu_torch.data.pipeline import BatchLoader
from usip_tpu_torch.eval.baselines import random_keypoints
from usip_tpu_torch.eval.export import (ensure_keypoint_number,
                                        select_keypoints, write_keypoints_bin)
from usip_tpu_torch.inference import resolve_device
from usip_tpu_torch.models.fused_infer import detector_infer_fused
from usip_tpu_torch.ops import sample_nodes
from usip_tpu_torch.ops.kernels import fusion_chain_params, prepare_chain
from usip_tpu_torch.train.checkpoint import restore_checkpoint
from usip_tpu_torch.train.loop import init_detector_state, stream_generator

# the seed of the export's node draws (usip_tpu's PRNGKey(123))
EXPORT_SEED = 123


class _SyntheticFrames:
    """The ``--synthetic`` eval set: the src copy of each synthetic item."""

    def __init__(self, cfg: Config, seed: int):
        from usip_tpu_torch.data.synthetic import SyntheticDataset
        self.base = SyntheticDataset(
            size=16, input_pc_num=cfg.data.input_pc_num,
            surface_normal_len=cfg.detector.surface_normal_len, seed=seed)

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        item = self.base[i]
        return {"pc": item["src_pc"], "sn": item["src_sn"],
                "seq": np.int64(0), "frame": np.int64(i)}


def make_eval_dataset(cfg: Config, synthetic: bool = False, seed: int = 0):
    if synthetic:
        return _SyntheticFrames(cfg, seed)
    from usip_tpu_torch.data import eval_loaders as el
    name = cfg.data.dataset
    sn = cfg.detector.surface_normal_len
    if name == "kitti":
        return el.KittiTestFrames(
            cfg.data, txt_root=os.path.join(cfg.data.dataroot, "kitti-reg-test"),
            numpy_root=os.path.join(cfg.data.dataroot, "data_odometry_velodyne",
                                    "numpy"), sn_len=sn)
    if name == "oxford":
        return el.OxfordTestFrames(cfg.data, sn_len=sn)
    raise NotImplementedError(
        f"export of the {name!r} eval frames is not ported (kitti, oxford "
        "and --synthetic are)")


def _pad_batch(a: np.ndarray, batch_size: int) -> np.ndarray:
    """A ragged tail batch padded to ``batch_size`` rows by repeating its
    last row (usip_tpu's ``_place_batch``), so the kernels see one shape."""
    pad = batch_size - a.shape[0]
    return np.concatenate([a, np.repeat(a[-1:], pad, axis=0)]) if pad > 0 else a


class ModelInfer:
    """The detector's eval forward from a checkpoint (the port's ``.pt`` or
    a usip_tpu ``.msgpack``): ``(pc, sn, node_draws) -> (keypoints,
    sigmas)``, nodes drawn on the device."""

    def __init__(self, cfg: Config, checkpoint: str, device):
        self.cfg = cfg
        self.device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        state = init_detector_state(cfg, cfg.train.seed, self.device)
        restore_checkpoint(checkpoint, state)
        self.model = state.model.eval()
        self.chain = prepare_chain(*fusion_chain_params(self.model.knnlayer_1))
        self.ratio = (cfg.data.eval_fps_subsample_ratio
                      or cfg.data.fps_subsample_ratio)

    @torch.no_grad()
    def __call__(self, pc: np.ndarray, sn: np.ndarray, generator=None,
                 draws=None):
        to = lambda a: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(a, np.float32)).to(self.device)
        d = [None if t is None else t.to(self.device)
             for t in (draws or (None, None))]
        node = sample_nodes(to(pc), self.cfg.data.node_num, self.ratio,
                            self.cfg.data.fps_parallel, subset_idx=d[0],
                            first=d[1], generator=generator)
        _, kp, sig = detector_infer_fused(self.model, to(pc), to(sn), node,
                                          self.chain)
        return kp.cpu().numpy(), sig.cpu().numpy()


def run_export(cfg: Config, checkpoint: Optional[str], out_dir: str,
               nms_radius: float = 0.0, desired_num: int = 128,
               synthetic: bool = False, batch_size: Optional[int] = None,
               dataset=None, method: str = "model", noise_sigma: float = 0.0,
               with_sigmas: bool = False, device="cuda",
               node_draws: Optional[Callable] = None) -> dict:
    """Export every frame of the eval set; returns summary stats (frames,
    mean keypoint count, clouds/s after the first batch).

    ``method``: 'model' (the trained detector) or 'random' (the classical
    random baseline, save_keypoints.py:289-325); ``noise_sigma`` adds
    gaussian noise to the input cloud (save_keypoints.py:34);
    ``with_sigmas`` writes 4-column (xyz, sigma) bins, the form the
    reference's visualize_keypoints viewer reads; pad-from-cloud rows carry
    sigma=inf. ``node_draws(i)``, where given, returns batch ``i``'s node
    draws ``(subset rows, FPS seed rows)`` instead of the generator's (the
    tests pass JAX's).
    """
    if method not in ("model", "random"):
        raise NotImplementedError(f"export method {method!r} is not ported "
                                  "(model and random are)")
    if with_sigmas and method != "model":
        raise ValueError("with_sigmas requires method='model' (classical "
                         "baselines carry no uncertainty estimate)")
    infer = ModelInfer(cfg, checkpoint, device) if method == "model" else None
    ds = dataset if dataset is not None else make_eval_dataset(cfg, synthetic)
    bs = batch_size or cfg.train.batch_size
    loader = BatchLoader(ds, bs, shuffle=False, num_workers=4, drop_last=False)
    rng = np.random.default_rng(0)

    frames = 0
    counts = []
    t_start = None
    frames_at_start = 0
    for i, raw in enumerate(loader):
        pc_batch = raw["pc"]
        if noise_sigma > 0:
            pc_batch = pc_batch + rng.normal(
                scale=noise_sigma, size=pc_batch.shape).astype(pc_batch.dtype)
        real_b = pc_batch.shape[0]
        if infer is not None:
            gen = None if node_draws is not None else stream_generator(
                infer.device, EXPORT_SEED, 0, i)
            kp, sig = infer(_pad_batch(pc_batch, bs), _pad_batch(raw["sn"], bs),
                            generator=gen,
                            draws=node_draws(i) if node_draws else None)
            kp, sig = kp[:real_b], sig[:real_b]
        for b in range(real_b):
            if infer is not None:
                selected = select_keypoints(kp[b], sig[b], pc_batch[b],
                                            nms_radius=nms_radius,
                                            desired_num=desired_num, rng=rng,
                                            return_sigmas=with_sigmas)
                if with_sigmas:
                    sel_kp, sel_sig = selected
                    selected = np.concatenate(
                        [sel_kp, sel_sig[:, None].astype(sel_kp.dtype)], axis=1)
            else:
                selected = ensure_keypoint_number(
                    random_keypoints(rng, pc_batch[b], desired_num),
                    pc_batch[b], desired_num, rng)
            counts.append(selected.shape[0])
            seq, frame = int(raw["seq"][b]), int(raw["frame"][b])
            write_keypoints_bin(
                os.path.join(out_dir, f"{seq:02d}", f"{frame}.bin"), selected)
            frames += 1
        if i == 0:
            # the timer starts after batch 0 is fully processed (the
            # kernels' first use and its host work), so frames and window
            # line up
            t_start = time.perf_counter()
            frames_at_start = frames
    elapsed = time.perf_counter() - (t_start or time.perf_counter())
    timed = max(frames - frames_at_start, 1)
    return {"frames": frames,
            "mean_keypoints": float(np.mean(counts)) if counts else 0.0,
            "clouds_per_sec": timed / elapsed if elapsed > 0 else 0.0}
