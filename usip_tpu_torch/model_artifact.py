"""Self-contained model artifacts via ``torch.export`` (counterpart of
``usip_tpu/model_artifact.py``).

An artifact bakes a checkpoint's weights into an exported program of the
port's serving forward, so that a serving process runs it with torch, the
kernel library (``ops.kernels``, whose import registers the ``usip::`` custom
ops the program calls) and the host post-processing, and with no model code,
config or checkpoint reader.

A file is the magic ``USIPTOR1``, a little-endian u32 header length, a JSON
header, then the programs: one ``torch.export.save`` program for each
platform listed (an exported graph keeps its device), at the offset and of
the size the header gives. The header carries usip_tpu's fields (kind,
batch, input_pc_num, sn_len, node_num, descriptor_len, keypoint_num,
platforms, dataset, outputs) and each input's name, shape and dtype. Shapes
are static: one artifact per (batch, input_pc_num) serving configuration.

Calling convention (usip_tpu's ``key`` becomes the draws, inputs of the
program):
  detector:   (pc (B,N,3) f32, sn (B,N,S) f32, subset (B,sub) i64,
               first (B*fps_parallel,) i64) -> (keypoints (B,M,3), sigmas (B,M))
  descriptor: (pc, sn, kp (B,K,3), priority (B,N) f32) -> descriptors (B,K,D)
  pipeline:   (pc, sn, subset, first, priority)
               -> (keypoints, sigmas, descriptors (B,M,D))

NMS and sigma ranking stay host-side, as in the export tool
(``eval/export.py``).
"""

from __future__ import annotations

import io
import json
import os
import struct
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from usip_tpu_torch.ops import kernels  # noqa: F401  (registers usip::*)
from usip_tpu_torch.ops.grouping import ball_priority_draws
from usip_tpu_torch.ops.sampling import _node_shapes, node_draws

_MAGIC = b"USIPTOR1"
# usip_tpu's (JAX) artifacts: recognised, to be refused by name
_JAX_MAGIC = b"USIPART1"
PLATFORMS = ("cpu", "cuda")


# ----------------------------------------------------------------- file --

def _write(path: str, header: dict, programs: dict) -> None:
    """``programs``: platform -> the bytes of ``torch.export.save``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    header = dict(header, programs={})
    off = 0
    for platform, blob in programs.items():
        header["programs"][platform] = {"offset": off, "size": len(blob)}
        off += len(blob)
    hdr = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(hdr)))
        f.write(hdr)
        for blob in programs.values():
            f.write(blob)


def _read(path: str) -> Tuple[dict, bytes]:
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic == _JAX_MAGIC:
            raise ValueError(f"{path}: a usip_tpu (JAX) model artifact "
                             f"(magic {magic!r}); usip_tpu_torch loads only "
                             "its own (export it with `python -m "
                             "usip_tpu_torch.cli export-model`)")
        if magic != _MAGIC:
            raise ValueError(f"{path}: not a usip_tpu_torch model artifact "
                             f"(bad magic {magic!r})")
        (hlen,) = struct.unpack("<I", f.read(4))
        header = json.loads(f.read(hlen).decode())
        blob = f.read()
    return header, blob


# --------------------------------------------------------------- export --

def _platforms(platforms: Sequence[str]) -> Tuple[str, ...]:
    platforms = tuple(platforms)
    bad = [p for p in platforms if p not in PLATFORMS]
    if not platforms or bad:
        raise ValueError(f"platforms {platforms!r}: choose from {PLATFORMS}")
    if "cuda" in platforms and not torch.cuda.is_available():
        raise RuntimeError("platform 'cuda' requested but CUDA is not "
                           "available")
    return platforms


def _export(make, args: Sequence[torch.Tensor],
            platforms: Sequence[str]) -> dict:
    """``make(device)(*args)`` exported once for each platform, on its
    device: platform -> program bytes. The module is built on the device,
    so that the chain's weights are folded there, as ``KeypointPipeline``
    folds them (the card's rsqrt rounds apart from the CPU's). Outside
    ``torch.inference_mode`` (export refuses inference tensors), gradients
    off."""
    programs = {}
    for platform in _platforms(platforms):
        dev = torch.device(platform)
        mod = make(dev).eval()
        with torch.inference_mode(False), torch.no_grad():
            ep = torch.export.export(mod, tuple(a.to(dev) for a in args))
        ep.example_inputs = None    # the header gives the inputs' shapes
        buf = io.BytesIO()
        torch.export.save(ep, buf)
        programs[platform] = buf.getvalue()
    return programs


def _input(name: str, t: torch.Tensor) -> dict:
    return {"name": name, "shape": list(t.shape),
            "dtype": str(t.dtype).replace("torch.", "")}


def _detector_program(cfg, checkpoint, device):
    """The detector's serving forward as a module on ``device``:
    ``sample_nodes`` from the given draws, then ``detector_infer_fused``
    with the fusion chain's folded, packed weights held as buffers."""
    from usip_tpu_torch.models.detector import Detector
    from usip_tpu_torch.models.fused_infer import detector_infer_fused
    from usip_tpu_torch.ops.kernels import fusion_chain_params, prepare_chain
    from usip_tpu_torch.ops.sampling import sample_nodes
    from usip_tpu_torch.weights import load_detector_weights

    det = Detector(cfg.detector)
    sd = (load_detector_weights(checkpoint) if isinstance(checkpoint, str)
          else checkpoint)
    det.load_state_dict(sd, strict=True)
    det = det.to(device).eval()
    chain = prepare_chain(*fusion_chain_params(det.knnlayer_1))
    del det.knnlayer_1      # served by the chain's buffers

    class DetectorProgram(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.det = det
            self.register_buffer("packed", chain.packed)
            for i, b in enumerate(chain.biases):
                self.register_buffer(f"b{i + 1}", b)

        def forward(self, pc, sn, subset, first):
            node = sample_nodes(pc, cfg.data.node_num, _eval_ratio(cfg),
                                cfg.data.fps_parallel, subset_idx=subset,
                                first=first)
            buffers = chain._replace(
                biases=(self.b1, self.b2, self.b3, self.b4, self.b5),
                packed=self.packed)
            _, kp, sig = detector_infer_fused(self.det, pc, sn, node,
                                              buffers)
            return kp, sig

    return DetectorProgram()


def _eval_ratio(cfg) -> int:
    return cfg.data.eval_fps_subsample_ratio or cfg.data.fps_subsample_ratio


def _descriptor_program(cfg, descriptor_checkpoint, device):
    """``Descriptor.forward`` on ``device`` with the ball priorities
    given."""
    from usip_tpu_torch.models.descriptor import Descriptor
    from usip_tpu_torch.weights import load_descriptor_weights

    desc = Descriptor(cfg.descriptor)
    sd = (load_descriptor_weights(descriptor_checkpoint)
          if isinstance(descriptor_checkpoint, str)
          else descriptor_checkpoint)
    desc.load_state_dict(sd, strict=True)

    class DescriptorProgram(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.desc = desc.to(device).eval()

        def forward(self, pc, sn, kp, priority):
            return self.desc(pc, sn, kp, priority)[0]

    return DescriptorProgram()


def _node_inputs(cfg, batch: int):
    n = cfg.data.input_pc_num
    sub, parallel = _node_shapes(n, cfg.data.node_num, _eval_ratio(cfg),
                                 cfg.data.fps_parallel)
    subset = torch.arange(sub).repeat(batch, 1)
    first = torch.zeros(batch * parallel, dtype=torch.int64)
    return subset, first


def _cloud_inputs(cfg, batch: int, sn_len: int):
    n = cfg.data.input_pc_num
    return (torch.zeros(batch, n, 3), torch.zeros(batch, n, sn_len))


def _header(cfg, kind: str, batch: int, sn_len: int, platforms, outputs,
            names, args, **extra) -> dict:
    return {"kind": kind, "batch": batch,
            "input_pc_num": cfg.data.input_pc_num, "sn_len": sn_len,
            **extra, "platforms": list(platforms),
            "dataset": cfg.data.dataset, "outputs": outputs,
            "inputs": [_input(n, a) for n, a in zip(names, args)]}


def export_detector_artifact(cfg, checkpoint, path: str, batch: int = 1,
                             platforms: Sequence[str] = ("cuda",)) -> dict:
    """Bake the detector checkpoint (a path ``weights.load_detector_weights``
    reads, or a ``state_dict``) into an exported program and write it.
    Returns the header."""
    s = cfg.detector.surface_normal_len
    args = _cloud_inputs(cfg, batch, s) + _node_inputs(cfg, batch)
    header = _header(cfg, "detector", batch, s, platforms,
                     ["keypoints", "sigmas"],
                     ("pc", "sn", "subset", "first"), args,
                     node_num=cfg.data.node_num,
                     subsample_ratio=_eval_ratio(cfg),
                     fps_parallel=cfg.data.fps_parallel)
    _write(path, header, _export(
        lambda dev: _detector_program(cfg, checkpoint, dev), args,
        platforms))
    return header


def export_descriptor_artifact(cfg, descriptor_checkpoint, path: str,
                               batch: int = 1, num_keypoints: int = 128,
                               platforms: Sequence[str] = ("cuda",)) -> dict:
    """Bake the descriptor into an exported ``(pc, sn, kp, priority) ->
    desc`` program. ``num_keypoints`` fixes the keypoint set's shape: the
    serving pipeline's post-NMS count (the export protocol's 128)."""
    s = cfg.descriptor.surface_normal_len
    b, n = batch, cfg.data.input_pc_num
    args = _cloud_inputs(cfg, b, s) + (torch.zeros(b, num_keypoints, 3),
                                       torch.zeros(b, n))
    header = _header(cfg, "descriptor", batch, s, platforms, ["descriptors"],
                     ("pc", "sn", "kp", "priority"), args,
                     keypoint_num=num_keypoints,
                     descriptor_len=cfg.descriptor.descriptor_len)
    _write(path, header, _export(
        lambda dev: _descriptor_program(cfg, descriptor_checkpoint, dev),
        args, platforms))
    return header


def export_pipeline_artifact(cfg, detector_checkpoint, descriptor_checkpoint,
                             path: str, batch: int = 1,
                             platforms: Sequence[str] = ("cuda",)) -> dict:
    """One program: ``(pc, sn, subset, first, priority) -> (keypoints (B,M,3),
    sigmas (B,M), descriptors (B,M,D))``, the detector and the descriptor of
    every proposal in one call; the runner picks paired rows afterwards
    (``eval.export.select_keypoint_indices``)."""
    class PipelineProgram(torch.nn.Module):
        def __init__(self, device):
            super().__init__()
            self.detector = _detector_program(cfg, detector_checkpoint,
                                              device)
            self.descriptor = _descriptor_program(cfg, descriptor_checkpoint,
                                                  device)

        def forward(self, pc, sn, subset, first, priority):
            kp, sig = self.detector(pc, sn, subset, first)
            return kp, sig, self.descriptor(pc, sn, kp, priority)

    s = cfg.detector.surface_normal_len
    args = (_cloud_inputs(cfg, batch, s) + _node_inputs(cfg, batch)
            + (torch.zeros(batch, cfg.data.input_pc_num),))
    header = _header(cfg, "pipeline", batch, s, platforms,
                     ["keypoints", "sigmas", "descriptors"],
                     ("pc", "sn", "subset", "first", "priority"), args,
                     node_num=cfg.data.node_num,
                     subsample_ratio=_eval_ratio(cfg),
                     fps_parallel=cfg.data.fps_parallel,
                     descriptor_len=cfg.descriptor.descriptor_len)
    _write(path, header, _export(PipelineProgram, args, platforms))
    return header


# ----------------------------------------------------------------- load --

def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev


class LoadedArtifact:
    """A loaded artifact: ``header``, ``device`` and a direct ``__call__``
    on tensors or arrays (moved to the device), gradients off."""

    def __init__(self, header: dict, module, device: torch.device):
        self.header = header
        self.device = device
        self._module = module

    def __call__(self, *args):
        args = [(a if torch.is_tensor(a) else torch.from_numpy(np.array(a)))
                .to(self.device) for a in args]
        with torch.inference_mode():
            return self._module(*args)


def load_artifact(path: str, device="cuda") -> LoadedArtifact:
    """The program of ``path`` for ``device``'s type. On the card, TF32
    goes off for cuBLAS and cuDNN, as ``KeypointPipeline`` sets it, so the
    artifact's fp32 products round as the in-process port's."""
    dev = _device(device)
    header, blob = _read(path)
    entry = header["programs"].get(dev.type)
    if entry is None:
        raise ValueError(f"{path}: exported for {header['platforms']}, not "
                         f"for {dev.type!r} (export-model --platforms)")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ep = torch.export.load(io.BytesIO(
        blob[entry["offset"]:entry["offset"] + entry["size"]]))
    return LoadedArtifact(header, ep.module(), dev)


# ------------------------------------------------------------------ run --

def artifact_draws(header: dict, generator: torch.Generator):
    """The draws of one call of a detector or pipeline artifact, from
    ``generator`` on its device: the subset rows and FPS seed rows
    (``ops.sampling.node_draws``) and, for a pipeline, the ball priorities
    (``ops.grouping.ball_priority_draws``)."""
    b, n = header["batch"], header["input_pc_num"]
    subset, first = node_draws(b, n, header["node_num"],
                               header["subsample_ratio"],
                               header["fps_parallel"], generator=generator)
    draws = (subset, first.long())
    if header["kind"] == "pipeline":
        draws += (ball_priority_draws(b, n, generator=generator),)
    return draws


def run_detector_artifact(artifact_path: str, inputs: Sequence[str],
                          out_dir: str, num_keypoints: int = 128,
                          nms_radius: float = 0.0,
                          desc_artifact_path: Optional[str] = None,
                          seed: int = 0, device="cuda") -> dict:
    """Serve raw ``.npy`` clouds through a detector or pipeline artifact
    (the ``detect`` command's IO contract: ``<name>.keypoints.bin`` and,
    with descriptors, ``<name>.desc.bin`` a cloud), with no model code or
    checkpoint.

    Clouds are subsampled or padded to the artifact's pinned (batch, N);
    a ragged last batch is padded by repetition and trimmed. Keypoint
    selection (NMS, sigma rank, count) is host-side, the export tool's.
    With a pipeline artifact the descriptors come from the same call and
    selection picks paired rows by index, with no pad-from-cloud (a frame
    that NMS leaves short writes fewer rows); with a descriptor artifact
    the selected set is described again. Device draws come from a
    ``torch.Generator`` on ``device`` seeded with ``seed``, host draws from
    ``np.random.default_rng(seed)``.
    """
    from usip_tpu_torch.data.common import subsample_fixed
    from usip_tpu_torch.eval.export import (select_keypoint_indices,
                                            select_keypoints)

    art = load_artifact(artifact_path, device)
    pipeline = art.header["kind"] == "pipeline"
    if art.header["kind"] not in ("detector", "pipeline"):
        raise ValueError(f"{artifact_path}: kind={art.header['kind']!r}, "
                         "expected a detector or pipeline artifact")
    desc_art = None
    if desc_artifact_path is not None:
        if pipeline:
            raise ValueError("a pipeline artifact already embeds its "
                             "descriptor — drop --desc-artifact")
        desc_art = load_artifact(desc_artifact_path, device)
        if desc_art.header["kind"] != "descriptor":
            raise ValueError(f"{desc_artifact_path}: kind="
                             f"{desc_art.header['kind']!r}, expected "
                             "a descriptor artifact")
        if desc_art.header["keypoint_num"] != num_keypoints:
            raise ValueError(
                f"descriptor artifact was exported for "
                f"{desc_art.header['keypoint_num']} keypoints, "
                f"got --num-keypoints {num_keypoints}")

    b = art.header["batch"]
    n = art.header["input_pc_num"]
    s = art.header["sn_len"]
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=art.device).manual_seed(seed)
    os.makedirs(out_dir, exist_ok=True)

    frames = 0
    for start in range(0, len(inputs), b):
        chunk = list(inputs[start:start + b])
        real = len(chunk)
        pcs, sns = [], []
        for path in chunk:
            data = np.load(path).astype(np.float32)
            if data.shape[1] < 3 + s:
                data = np.concatenate(
                    [data[:, :3],
                     np.zeros((data.shape[0], s), np.float32)], axis=1)
            fixed = subsample_fixed(rng, data[:, :3 + s], n)
            pcs.append(fixed[:, :3])
            sns.append(fixed[:, 3:3 + s])
        while len(pcs) < b:  # ragged tail: pad by repetition, trim after
            pcs.append(pcs[-1])
            sns.append(sns[-1])
        out = art(np.stack(pcs), np.stack(sns),
                  *artifact_draws(art.header, gen))
        if pipeline:
            kp, sig, all_desc = (x.cpu().numpy()[:real] for x in out)
            for i, path in enumerate(chunk):
                idx = select_keypoint_indices(kp[i], sig[i],
                                              nms_radius=nms_radius,
                                              desired_num=num_keypoints)
                name = os.path.splitext(os.path.basename(path))[0]
                kp[i][idx].astype(np.float32).tofile(
                    os.path.join(out_dir, f"{name}.keypoints.bin"))
                all_desc[i][idx].astype(np.float32).tofile(
                    os.path.join(out_dir, f"{name}.desc.bin"))
                frames += 1
            continue
        kp, sig = (x.cpu().numpy()[:real] for x in out)
        selected = np.stack([
            select_keypoints(kp[i], sig[i], pcs[i], nms_radius=nms_radius,
                             desired_num=num_keypoints, rng=rng)
            for i in range(real)])
        desc = None
        if desc_art is not None:
            sel_in = selected
            if real < b:
                sel_in = np.concatenate(
                    [selected, np.repeat(selected[-1:], b - real, axis=0)])
            priority = ball_priority_draws(b, n, generator=gen)
            desc = desc_art(np.stack(pcs), np.stack(sns),
                            sel_in.astype(np.float32),
                            priority).cpu().numpy()[:real]
        for i, path in enumerate(chunk):
            name = os.path.splitext(os.path.basename(path))[0]
            selected[i].astype(np.float32).tofile(
                os.path.join(out_dir, f"{name}.keypoints.bin"))
            if desc is not None:
                desc[i].astype(np.float32).tofile(
                    os.path.join(out_dir, f"{name}.desc.bin"))
            frames += 1
    return {"clouds": frames, "out": out_dir}
