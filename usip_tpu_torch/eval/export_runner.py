"""Batched keypoint export over an eval dataset (counterpart of
``usip_tpu/eval/export_runner.py``: ``make_eval_dataset :23``,
``run_export_with_descriptors :95``, ``run_export :187``,
``FragmentFrames``/``run_export_fragments :276-368``): the detector's eval
forward on the device, host NMS and sigma ranking, a ``.bin`` per frame
(the reference's save_keypoints.py main loop, :229-414); with a descriptor,
the selected keypoints go back to the device to be described, and their
descriptors get a parallel ``.bin`` tree (the registration eval's input),
or, for indoor fragments, one ``[x y z d_0..d_127]`` row per keypoint (the
input of ``eval-indoor``).

The forward is ``models.fused_infer.detector_infer_fused`` on the restored
model (the port's serving forward: FPS, min/argmin, scatter-max, smallest-k
and the fused chain on the card).

Over several ranks (``train.num_devices > 1``, usip_tpu's ``_place_batch``
under a mesh): every rank reads each batch of the global batch size, pads
it to a multiple of the ranks, detects (and describes) its own rows and
writes its own frames. Batch ``i``'s rows of rank ``r`` draw their nodes
(and ball priorities) from the streams of batch ``i R + r``, so the trees
are byte for byte those of one rank at the per-rank batch size, wherever
the host selection draws nothing (no ``noise_sigma``, no cloud short of
keypoints: each rank draws those from its own ``rng``).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from usip_tpu_torch.config import Config
from usip_tpu_torch.data.common import split_pc_sn, subsample_fixed
from usip_tpu_torch.data.pipeline import BatchLoader
from usip_tpu_torch.eval.baselines import baseline_keypoints
from usip_tpu_torch.eval.export import (ensure_keypoint_number,
                                        select_keypoints, write_keypoints_bin)
from usip_tpu_torch.inference import resolve_device
from usip_tpu_torch.models import Descriptor
from usip_tpu_torch.models.fused_infer import detector_infer_fused
from usip_tpu_torch.ops import sample_nodes
from usip_tpu_torch.ops.kernels import fusion_chain_params, prepare_chain
from usip_tpu_torch.train.checkpoint import restore_checkpoint
from usip_tpu_torch.train.loop import init_detector_state, stream_generator
from usip_tpu_torch.weights import load_descriptor_weights

# the seed of the export's node draws (usip_tpu's PRNGKey(123)), and of the
# descriptor export's node and ball draws (PRNGKey(321))
EXPORT_SEED = 123
DESCRIPTOR_EXPORT_SEED = 321


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


def make_eval_dataset(cfg: Config, synthetic: bool = False, seed: int = 0,
                      subset: str = "original"):
    """The eval frames of ``cfg.data.dataset`` (usip_tpu's, dataset by
    dataset); ``subset`` picks the original or the rotated half of the
    rotated-ModelNet repeatability protocol (modelnet_rotated_loader.py)."""
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
    if name == "scenenn":
        return el.RedwoodFrames(cfg.data, sn_len=sn)
    if name == "match3d":
        return el.Match3DEvalFrames(cfg.data, sn_len=sn)
    if name in ("modelnet", "shrec"):
        return el.ModelNetRotatedFrames(cfg.data, sn_len=sn, subset=subset)
    raise KeyError(name)


def _pad_batch(a: np.ndarray, batch_size: int) -> np.ndarray:
    """A ragged tail batch padded to ``batch_size`` rows by repeating its
    last row (usip_tpu's ``_place_batch``), so the kernels see one shape."""
    pad = batch_size - a.shape[0]
    return np.concatenate([a, np.repeat(a[-1:], pad, axis=0)]) if pad > 0 else a


class _Ranks:
    """This process's part of a multi-rank export: its rows of each padded
    global batch and the stream index of its part of batch ``i``; at one
    rank, the whole batch and ``i``."""

    def __init__(self, cfg: Config, batch_size: int, device):
        from usip_tpu_torch.parallel.mesh import make_mesh
        n = cfg.train.num_devices
        self.mesh = make_mesh(n, device) if n > 1 else None
        self.size = 1 if self.mesh is None else self.mesh.size
        self.rank = 0 if self.mesh is None else self.mesh.rank
        # the padded batch splits over the ranks (usip_tpu's _place_batch)
        self.padded = batch_size + (-batch_size) % self.size
        self.local = self.padded // self.size
        self.rows = slice(self.rank * self.local,
                          (self.rank + 1) * self.local)
        self.device = None if self.mesh is None else self.mesh.device

    def take(self, a: np.ndarray) -> np.ndarray:
        """This rank's rows of a batch, padded first."""
        return _pad_batch(a, self.padded)[self.rows]

    def real(self, real_b: int) -> range:
        """The batch positions of this rank's rows that are real frames."""
        return range(self.rows.start, min(self.rows.stop, real_b))

    def stream(self, i: int) -> int:
        return i * self.size + self.rank

    def gather(self, value) -> list:
        """``value`` of every rank (host values)."""
        if self.mesh is None:
            return [value]
        from usip_tpu_torch.parallel.mesh import all_gather_object
        return all_gather_object(value, self.mesh)

    def total(self, frames: int) -> int:
        """Frames written over every rank."""
        return sum(self.gather(frames))


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


def _frame_yaw_matrix(seed: int, seq: int, frame: int) -> np.ndarray:
    """A fixed yaw for each frame (about the camera frame's vertical y axis,
    the '2d' regime): ``R = Ry(theta)``, theta ~ U(0, 2 pi) seeded by
    ``(seed, seq, frame)``."""
    theta = np.random.default_rng([seed, seq, frame]).uniform(0.0, 2 * np.pi)
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], np.float32)


class DescriptorInfer:
    """The descriptor's eval forward from a checkpoint
    (``weights.load_descriptor_weights``: the port's ``.pt``, a usip_tpu
    ``.msgpack`` or a reference ``.pth``): ``(pc, sn, keypoints) ->
    descriptors``, the ball priorities drawn on the device."""

    def __init__(self, cfg: Config, checkpoint: str, device):
        self.device = resolve_device(device)
        model = Descriptor(cfg.descriptor)
        model.load_state_dict(load_descriptor_weights(checkpoint), strict=True)
        self.model = model.to(self.device).eval()

    @torch.no_grad()
    def __call__(self, pc: np.ndarray, sn: np.ndarray, keypoints: np.ndarray,
                 generator: Optional[torch.Generator] = None,
                 priority: Optional[torch.Tensor] = None) -> np.ndarray:
        to = lambda a: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(a, np.float32)).to(self.device)
        if priority is not None:
            priority = priority.to(self.device)
        desc, _ = self.model(to(pc), to(sn), to(keypoints), priority,
                             generator=generator)
        return desc.cpu().numpy()


def run_export_with_descriptors(cfg: Config, detector_checkpoint: str,
                                descriptor_checkpoint: str, kp_out: str,
                                desc_out: str, nms_radius: float = 0.0,
                                desired_num: int = 128,
                                synthetic: bool = False,
                                batch_size: Optional[int] = None,
                                dataset=None,
                                frame_yaw_seed: Optional[int] = None,
                                device="cuda") -> dict:
    """Export keypoints and their descriptors as parallel ``.bin`` trees,
    the input of the registration eval (evaluate_kitti.m:43-54): detection
    through the fused forward, keypoint selection (NMS, sigma top-K) on the
    host, then the selected set through the descriptor on the device.

    ``frame_yaw_seed``: each frame's cloud (and ``sn[..., :3]``) is rotated
    by its own yaw (``_frame_yaw_matrix``) before detection and
    description, and the keypoints are rotated back before they are
    written; the registration GT holds unchanged, while the descriptors are
    computed in mutually yaw-rotated frames (the LiDAR protocol that tells a
    yaw-trained descriptor from an untrained one).
    """
    bs = batch_size or cfg.train.batch_size
    ranks = _Ranks(cfg, bs, device)
    device = ranks.device or device
    infer = ModelInfer(cfg, detector_checkpoint, device)
    describe = DescriptorInfer(cfg, descriptor_checkpoint, device)
    ds = dataset if dataset is not None else make_eval_dataset(cfg, synthetic)
    loader = BatchLoader(ds, bs, shuffle=False, num_workers=4, drop_last=False)
    rng = np.random.default_rng(0)
    frames = 0
    for i, raw in enumerate(loader):
        real_b = raw["pc"].shape[0]
        mine = ranks.real(real_b)
        raw = {k: ranks.take(np.asarray(v)) for k, v in raw.items()}
        pc_np, sn_np = raw["pc"], raw["sn"]
        real_b = len(mine)
        if real_b == 0:  # this rank holds only padding rows
            continue
        rots = None
        if frame_yaw_seed is not None:
            # the real rows only (a ragged batch's padding is re-made from
            # the rotated rows below, as the unrotated path's is)
            pc_np, sn_np = pc_np[:real_b], sn_np[:real_b]
            rots = [_frame_yaw_matrix(frame_yaw_seed, int(raw["seq"][b]),
                                      int(raw["frame"][b]))
                    for b in range(real_b)]
            pc_np = np.stack([pc_np[b] @ rots[b].T for b in range(real_b)])
            if sn_np.shape[-1] >= 3:
                sn_np = np.concatenate(
                    [np.stack([sn_np[b, :, :3] @ rots[b].T
                               for b in range(real_b)]),
                     sn_np[..., 3:]], axis=-1)
        gen = lambda j: stream_generator(  # noqa: E731
            infer.device, DESCRIPTOR_EXPORT_SEED, 0, j)
        pc_in = _pad_batch(pc_np, ranks.local)
        sn_in = _pad_batch(sn_np, ranks.local)
        kp, sig = infer(pc_in, sn_in, generator=gen(2 * ranks.stream(i)))
        selected = np.stack([
            select_keypoints(kp[b], sig[b], pc_np[b], nms_radius=nms_radius,
                             desired_num=desired_num, rng=rng)
            for b in range(real_b)])
        desc = describe(pc_in, sn_in, _pad_batch(selected, ranks.local),
                        generator=gen(2 * ranks.stream(i) + 1))[:real_b]
        for b in range(real_b):
            seq, frame = int(raw["seq"][b]), int(raw["frame"][b])
            kp_write = selected[b] @ rots[b] if rots is not None \
                else selected[b]
            write_keypoints_bin(
                os.path.join(kp_out, f"{seq:02d}", f"{frame}.bin"), kp_write)
            write_keypoints_bin(
                os.path.join(desc_out, f"{seq:02d}", f"{frame}.bin"), desc[b])
            frames += 1
    return {"frames": ranks.total(frames)}


def run_export(cfg: Config, checkpoint: Optional[str], out_dir: str,
               nms_radius: float = 0.0, desired_num: int = 128,
               synthetic: bool = False, batch_size: Optional[int] = None,
               dataset=None, method: str = "model", noise_sigma: float = 0.0,
               with_sigmas: bool = False, device="cuda",
               node_draws: Optional[Callable] = None,
               subset: str = "original") -> dict:
    """Export every frame of the eval set; returns summary stats (frames,
    mean keypoint count, clouds/s after the first batch).

    ``method``: 'model' (the trained detector) or a classical baseline,
    'random', 'iss', 'harris' or 'sift' at its defaults
    (save_keypoints.py:289-325); ``noise_sigma`` adds gaussian noise to
    the input cloud (save_keypoints.py:34); ``with_sigmas`` writes
    4-column (xyz, sigma) bins, the form the reference's
    visualize_keypoints viewer reads; pad-from-cloud rows carry sigma=inf.
    ``node_draws(i)``, where given, returns batch ``i``'s node draws
    ``(subset rows, FPS seed rows)`` instead of the generator's (the tests
    pass JAX's). ``subset``: the rotated-ModelNet half to export.
    """
    if method not in ("model", "random", "iss", "harris", "sift"):
        raise KeyError(f"unknown export method {method!r}")
    if with_sigmas and method != "model":
        raise ValueError("with_sigmas requires method='model' (classical "
                         "baselines carry no uncertainty estimate)")
    bs = batch_size or cfg.train.batch_size
    ranks = _Ranks(cfg, bs, device)
    device = ranks.device or device
    infer = ModelInfer(cfg, checkpoint, device) if method == "model" else None
    ds = dataset if dataset is not None else make_eval_dataset(
        cfg, synthetic, subset=subset)
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
        real_b = len(ranks.real(pc_batch.shape[0]))
        raw = {k: ranks.take(np.asarray(v)) for k, v in raw.items()}
        pc_batch = ranks.take(pc_batch)
        if infer is not None and real_b > 0:
            gen = None if node_draws is not None else stream_generator(
                infer.device, EXPORT_SEED, 0, ranks.stream(i))
            draws = None
            if node_draws is not None:
                subset_idx, first = node_draws(i)
                per = first.shape[0] // subset_idx.shape[0]
                draws = (subset_idx[ranks.rows],
                         first[ranks.rows.start * per:ranks.rows.stop * per])
            kp, sig = infer(pc_batch, raw["sn"], generator=gen, draws=draws)
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
                raw_kp = baseline_keypoints(
                    method, pc_batch[b], rng,
                    **({"num": desired_num} if method == "random" else {}))
                selected = ensure_keypoint_number(raw_kp, pc_batch[b],
                                                  desired_num, rng)
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
    timed = max(ranks.total(frames - frames_at_start), 1)
    frames = ranks.total(frames)
    counts = [c for part in ranks.gather(counts) for c in part]
    return {"frames": frames,
            "mean_keypoints": float(np.mean(counts)) if counts else 0.0,
            "clouds_per_sec": timed / elapsed if elapsed > 0 else 0.0}


class FragmentFrames:
    """Eval dataset over an indoor fragment tree ``<pc_root>/<scene>/<i>.npy``
    (the layout of ``cli eval-indoor --pc-root`` and the real 3DMatch
    fragment dumps, match3d_eval_loader.py:39-57): yields fixed-size
    subsamples with (seq=scene index, frame=i) keys."""

    def __init__(self, cfg: Config, pc_root: str, scenes, sn_len: int = 4,
                 seed: int = 0):
        self.cfg = cfg.data
        self.pc_root = pc_root
        self.sn_len = sn_len
        self._rng = np.random.default_rng(seed)
        self.items = []
        for si, scene in enumerate(scenes):
            folder = os.path.join(pc_root, scene)
            n = len([f for f in os.listdir(folder) if f.endswith(".npy")])
            for i in range(n):
                self.items.append((si, scene, i))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index):
        si, scene, frame = self.items[index]
        data = np.load(os.path.join(self.pc_root, scene, f"{frame}.npy"))
        data = subsample_fixed(self._rng, data, self.cfg.input_pc_num)
        pc, sn = split_pc_sn(data, self.sn_len)
        return {"pc": pc, "sn": sn, "seq": np.int64(si),
                "frame": np.int64(frame)}


def run_export_fragments(cfg: Config, detector_checkpoint: str,
                         descriptor_checkpoint: str, pc_root: str,
                         out_root: str, scenes, nms_radius: float = 0.0,
                         desired_num: int = 256,
                         batch_size: Optional[int] = None, device="cuda",
                         node_draws: Optional[Callable] = None,
                         ball_priorities: Optional[Callable] = None) -> dict:
    """Export per-fragment keypoint+descriptor features as the combined
    ``<out_root>/<scene>/<i>.bin`` rows ``[x y z d_0..d_{D-1}]``, the input
    of the indoor registration eval (register2Fragments.m:23-30 via
    Utils.load_descriptors; read by ``eval/indoor.py
    load_fragment_features`` and ``cli eval-indoor --result-root``).

    Batch ``i``'s node draws come from ``stream_generator(device, 321, 0,
    2 i)`` and its ball priorities from ``(..., 2 i + 1)`` (usip_tpu's
    ``fold_in(PRNGKey(321), 2 i)`` and ``2 i + 1``), or, where given, from
    ``node_draws(i)`` (subset rows, FPS seed rows) and ``ball_priorities(i)``
    (``(B, N)``): the tests pass JAX's.
    """
    infer = ModelInfer(cfg, detector_checkpoint, device)
    describe = DescriptorInfer(cfg, descriptor_checkpoint, device)
    ds = FragmentFrames(cfg, pc_root, scenes,
                        sn_len=cfg.detector.surface_normal_len)
    bs = batch_size or cfg.train.batch_size
    loader = BatchLoader(ds, bs, shuffle=False, num_workers=2,
                         drop_last=False)
    rng = np.random.default_rng(0)
    frames = 0
    scene_names = list(scenes)
    for i, raw in enumerate(loader):
        gen = lambda j: stream_generator(  # noqa: E731
            infer.device, DESCRIPTOR_EXPORT_SEED, 0, j)
        real_b = raw["pc"].shape[0]
        pc_in, sn_in = _pad_batch(raw["pc"], bs), _pad_batch(raw["sn"], bs)
        kp, sig = infer(pc_in, sn_in,
                        generator=None if node_draws else gen(2 * i),
                        draws=node_draws(i) if node_draws else None)
        selected = np.stack([
            select_keypoints(kp[b], sig[b], raw["pc"][b],
                             nms_radius=nms_radius, desired_num=desired_num,
                             rng=rng)
            for b in range(real_b)])
        desc = describe(
            pc_in, sn_in, _pad_batch(selected, bs),
            generator=None if ball_priorities else gen(2 * i + 1),
            priority=ball_priorities(i) if ball_priorities else None)[:real_b]
        for b in range(real_b):
            scene = scene_names[int(raw["seq"][b])]
            frame = int(raw["frame"][b])
            rows = np.concatenate(
                [selected[b].astype(np.float32),
                 desc[b].astype(np.float32)], axis=1)
            path = os.path.join(out_root, scene, f"{frame}.bin")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            rows.tofile(path)
            frames += 1
    return {"frames": frames, "scenes": len(scene_names)}
