"""Keypoint inference over raw numpy clouds (port of ``usip_tpu/inference.py``).

Loads the detector once (either trunk family: SOM, or the grouped knn/ball
trunk), subsamples each cloud to the configured fixed size, samples nodes on
the device (random subset + FPS kernel), runs the eval forward with the
fusion stack on the fused chain kernel, and selects keypoints on the host
exactly like the export tool. With a descriptor checkpoint the selected
keypoints are then described on the device (``detect_and_describe``).

On a CUDA device the batch's forward after its node draws is one CUDA graph
for each input shape (``device.ForwardGraph``, kept in a ``device.GraphCache``
whose ``graph_counts`` the pipeline shows): captured at the shape's first
call and replayed after, so the host makes a few copies and one launch a
batch in place of the forward's ~150 small launches. The node draws stay
eager, from the pipeline's own generator as on the CPU, written straight
into the graph's inputs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from usip_tpu_torch.config import Config
from usip_tpu_torch.data.common import subsample_fixed
from usip_tpu_torch.device import ForwardGraph, GraphCache, resolve_device
from usip_tpu_torch.eval.export import select_keypoints
from usip_tpu_torch.models.descriptor import Descriptor
from usip_tpu_torch.models.detector import Detector
from usip_tpu_torch.models.fused_infer import detector_infer_fused
from usip_tpu_torch.ops.kernels import fusion_chain_params, prepare_chain
from usip_tpu_torch.ops.sampling import (draw_node_uniforms,
                                         draws_from_uniforms,
                                         node_uniform_buffers, sample_nodes)
from usip_tpu_torch.utils.logging import span
from usip_tpu_torch.weights import (detector_family, load_descriptor_weights,
                                    load_detector_weights)


class KeypointPipeline:
    """Detector (and optional descriptor) inference on ``device`` from a
    checkpoint file (``weights.load_detector_weights``) or a
    ``state_dict``."""

    def __init__(self, cfg: Config, detector_checkpoint, device,
                 seed: int = 0, descriptor_checkpoint=None):
        self.device = resolve_device(device)
        # full fp32 products on the card: TF32, the cuDNN default, keeps about
        # three decimal digits, and the fp32 parity checks need all of them
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self._rng = np.random.default_rng(seed)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        named = isinstance(detector_checkpoint, str)
        sd = (load_detector_weights(detector_checkpoint) if named
              else detector_checkpoint)
        family = detector_family(sd)
        if family != ("som" if cfg.detector.grouping == "som" else "group"):
            raise ValueError(
                f"{detector_checkpoint if named else 'the state_dict'} "
                "holds a "
                f"{'grouped (knn/ball)' if family == 'group' else 'som'} "
                "detector but the config's detector.grouping is "
                f"{cfg.detector.grouping!r}; the released Oxford model is "
                "detector.grouping=ball")
        det = Detector(cfg.detector)
        det.load_state_dict(sd, strict=True)
        self.detector = det.to(self.device).eval()
        # the fusion chain's folded weights, packed once for its kernel
        self._chain = prepare_chain(
            *fusion_chain_params(self.detector.knnlayer_1))
        self._eval_ratio = (cfg.data.eval_fps_subsample_ratio
                            or cfg.data.fps_subsample_ratio)
        # on CUDA, one ForwardGraph a shape of (pc, sn), in one memory pool
        self._graphs = GraphCache()
        self._pool = None
        self.graph_counts = self._graphs.graph_counts
        self.descriptor = None
        if descriptor_checkpoint is not None:
            desc = Descriptor(cfg.descriptor)
            desc.load_state_dict(
                load_descriptor_weights(descriptor_checkpoint)
                if isinstance(descriptor_checkpoint, str)
                else descriptor_checkpoint, strict=True)
            self.descriptor = desc.to(self.device).eval()

    def _draw_buffers(self, pc: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``node_uniform_buffers`` at the shape of ``pc``."""
        d = self.cfg.data
        return node_uniform_buffers(*pc.shape[:2], d.node_num,
                                    self._eval_ratio, d.fps_parallel,
                                    device=pc.device)

    def _forward(self, pc: torch.Tensor, sn: torch.Tensor,
                 keys: torch.Tensor, first: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Nodes, keypoints and sigmas from ``draw_node_uniforms``' numbers
        ``keys`` and ``first``: the CPU's forward, and what a graph
        captures."""
        d = self.cfg.data
        subset, first = draws_from_uniforms(keys, first, d.node_num,
                                            self._eval_ratio, d.fps_parallel)
        node = sample_nodes(pc, d.node_num, self._eval_ratio, d.fps_parallel,
                            subset_idx=subset, first=first)
        _, kp, sig = detector_infer_fused(self.detector, pc, sn, node,
                                          self._chain)
        return node, kp, sig

    def _capture(self, pc: torch.Tensor, sn: torch.Tensor) -> ForwardGraph:
        """The graph of ``_forward`` at the shapes of ``pc`` and ``sn``, in
        the pipeline's one memory pool; captured on zeroed draws, so that
        nothing is drawn from the pipeline's generator."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return ForwardGraph(self._forward, (pc, sn) + self._draw_buffers(pc),
                            self._pool)

    @torch.inference_mode()
    def infer(self, pc: torch.Tensor, sn: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched forward on the device: ``pc (B, N, 3)``, ``sn (B, N, S)``
        -> keypoints ``(B, M, 3)``, sigmas ``(B, M)``, fresh tensors. The
        node draws, from the pipeline's generator on every device, are the
        span ``usip.infer.nodes``. On the CPU the forward runs eagerly; on
        CUDA it is the shape's ``ForwardGraph``, whose input copies and
        replay are the span ``usip.infer.replay`` (``graph_counts`` counts
        each kind of call). Calls run one at a time, on the current stream:
        a shape's calls share its graph's inputs and outputs."""
        if self.device.type == "cuda":
            graph = self._graphs.graph(
                (pc.shape, pc.dtype, sn.shape, sn.dtype),
                lambda: self._capture(pc, sn))
            inputs = graph.inputs
        else:
            graph, inputs = None, (pc, sn) + self._draw_buffers(pc)
            self._graphs.eager()
        d = self.cfg.data
        with span("usip.infer.nodes"):
            draw_node_uniforms(*inputs[2:], d.node_num, self._eval_ratio,
                               d.fps_parallel, generator=self._gen)
        if graph is None:
            return self._forward(*inputs)[1:]
        with span("usip.infer.replay"):
            inputs[0].copy_(pc)
            inputs[1].copy_(sn)
            _, kp, sig = graph.replay()
            return kp.clone(), sig.clone()

    def _fix_shape(self, pc: np.ndarray, sn: Optional[np.ndarray]):
        n = self.cfg.data.input_pc_num
        s = self.cfg.detector.surface_normal_len
        if sn is None:
            sn = np.zeros((pc.shape[0], s), np.float32)
        merged = np.concatenate([pc[:, :3].astype(np.float32),
                                 sn[:, :s].astype(np.float32)], axis=1)
        fixed = subsample_fixed(self._rng, merged, n)
        return fixed[:, :3], fixed[:, 3:]

    def detect(self, pc: np.ndarray, sn: Optional[np.ndarray] = None, *,
               num_keypoints: Optional[int] = None, nms_radius: float = 0.0
               ) -> Tuple[np.ndarray, np.ndarray]:
        """One cloud ``(N, 3)`` [+ normals ``(N, S)``] -> (keypoints ``(K, 3)``,
        sigmas ``(K,)``). With ``num_keypoints``, NMS + sigma ranking like the
        export tool; otherwise all M proposals sorted by sigma."""
        fpc, fsn = self._fix_shape(pc, sn)
        kp, sig = self.infer(
            torch.from_numpy(np.ascontiguousarray(fpc[None])).to(self.device),
            torch.from_numpy(np.ascontiguousarray(fsn[None])).to(self.device))
        kp, sig = kp[0].cpu().numpy(), sig[0].cpu().numpy()
        if num_keypoints is None:
            order = np.argsort(sig)
            return kp[order], sig[order]
        return select_keypoints(kp, sig, fpc, nms_radius=nms_radius,
                                desired_num=num_keypoints, rng=self._rng,
                                return_sigmas=True)

    def _to(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def detect_and_describe(self, pc: np.ndarray,
                            sn: Optional[np.ndarray] = None, *,
                            num_keypoints: int = 128,
                            nms_radius: float = 0.0
                            ) -> Tuple[np.ndarray, np.ndarray]:
        """One cloud -> (keypoints ``(K, 3)``, descriptors ``(K, D)``): the
        selected keypoints described in chunks of ``node_num``, a short
        chunk padded with random cloud points (one shape a call, as
        usip_tpu keeps one compiled program)."""
        if self.descriptor is None:
            raise ValueError("no descriptor checkpoint loaded")
        fpc, fsn = self._fix_shape(pc, sn)
        kp, sig = self.infer(self._to(fpc[None]), self._to(fsn[None]))
        kp, sig = kp[0].cpu().numpy(), sig[0].cpu().numpy()
        selected = select_keypoints(kp, sig, fpc, nms_radius=nms_radius,
                                    desired_num=num_keypoints, rng=self._rng)
        m = self.cfg.data.node_num
        k = selected.shape[0]
        descs = []
        for off in range(0, k, m):
            chunk = selected[off:off + m]
            if chunk.shape[0] < m:
                extra = fpc[self._rng.choice(fpc.shape[0],
                                             m - chunk.shape[0])]
                chunk = np.concatenate([chunk, extra])
            with torch.inference_mode():
                d, _ = self.descriptor(self._to(fpc[None]),
                                       self._to(fsn[None]),
                                       self._to(chunk[None]),
                                       generator=self._gen)
            descs.append(d[0].cpu().numpy()[:min(m, k - off)])
        return selected, np.concatenate(descs)
