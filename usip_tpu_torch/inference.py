"""Keypoint inference over raw numpy clouds (port of ``usip_tpu/inference.py``).

Loads the detector once (either trunk family: SOM, or the grouped knn/ball
trunk), subsamples each cloud to the configured fixed size, samples nodes on
the device (random subset + FPS kernel), runs the eval forward with the
fusion stack on the fused chain kernel, and selects keypoints on the host
exactly like the export tool.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from usip_tpu_torch.config import Config
from usip_tpu_torch.data.common import subsample_fixed
from usip_tpu_torch.eval.export import select_keypoints
from usip_tpu_torch.models.detector import Detector
from usip_tpu_torch.models.fused_infer import detector_infer_fused
from usip_tpu_torch.ops.kernels import fusion_chain_params, prepare_chain
from usip_tpu_torch.ops.sampling import sample_nodes
from usip_tpu_torch.weights import detector_family, load_detector_weights


def resolve_device(device) -> torch.device:
    """The torch device named by ``device``; a CUDA device raises when CUDA is
    absent rather than carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev


class KeypointPipeline:
    """Detector inference on ``device`` from a checkpoint file
    (``weights.load_detector_weights``) or a ``state_dict``."""

    def __init__(self, cfg: Config, detector_checkpoint, device,
                 seed: int = 0):
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

    @torch.inference_mode()
    def infer(self, pc: torch.Tensor, sn: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched forward on the device: ``pc (B, N, 3)``, ``sn (B, N, S)``
        -> keypoints ``(B, M, 3)``, sigmas ``(B, M)``."""
        node = sample_nodes(pc, self.cfg.data.node_num, self._eval_ratio,
                            self.cfg.data.fps_parallel, generator=self._gen)
        _, kp, sig = detector_infer_fused(self.detector, pc, sn, node,
                                          self._chain)
        return kp, sig

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
