"""Two-stage pipeline for the detect -> describe serving path (counterpart
of ``usip_tpu/parallel/pipeline_parallel.py``).

The detector is stage 0, the descriptor stage 1, each on its own device and
its own CUDA stream; microbatches stream through both. A stage-0 event
orders the keypoint handoff (a small ``(B, M, 3)`` copy when the stages
sit on two cards), so describe(i) waits only for detect(i) and detect(i +
1) overlaps it: the steady state is set by the slower stage, not the sum.
On one card both stages are that card (two streams of one device); on the
CPU the stages run in order. The detector's forward is the port's serving
forward (``detector_infer_fused``).
"""

from __future__ import annotations

import copy
from typing import List, Optional, Sequence, Tuple

import torch

from usip_tpu_torch.config import Config
from usip_tpu_torch.models.fused_infer import detector_infer_fused
from usip_tpu_torch.ops.kernels import fusion_chain_params, prepare_chain

Tensor = torch.Tensor


class DetectDescribePipeline:
    """Stage-placed detect -> describe pipeline.

    Args:
      cfg: the full config (detector and descriptor sections).
      detector / descriptor: a ``Detector`` and a ``Descriptor`` (copied to
        their stages' devices; the originals are left where they are).
      devices: the stages' two devices; default the first and the last
        visible card (one card twice on a one-card host: two streams of
        it), the CPU twice without CUDA.
    """

    def __init__(self, cfg: Config, detector, descriptor,
                 devices: Optional[Sequence] = None):
        if devices is None:
            if torch.cuda.is_available():
                devices = ("cuda:0", f"cuda:{torch.cuda.device_count() - 1}")
            else:
                devices = ("cpu", "cpu")
        if len(devices) != 2:
            raise ValueError("two pipeline stages -> two devices")
        self.cfg = cfg
        self.d0, self.d1 = (torch.device(d) for d in devices)
        self.detector = copy.deepcopy(detector).to(self.d0).eval()
        self.descriptor = copy.deepcopy(descriptor).to(self.d1).eval()
        self.chain = prepare_chain(*fusion_chain_params(
            self.detector.knnlayer_1))
        cuda = self.d0.type == "cuda"
        self.streams = ((torch.cuda.Stream(self.d0),
                         torch.cuda.Stream(self.d1)) if cuda else None)

    @torch.no_grad()
    def _detect(self, pc, sn, node):
        _, kp, sig = detector_infer_fused(self.detector, pc, sn, node,
                                          self.chain)
        return kp, sig

    @torch.no_grad()
    def __call__(self, microbatches: Sequence[Tuple[Tensor, Tensor, Tensor]],
                 priorities: Optional[Sequence[Tensor]] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> List[Tuple[Tensor, Tensor, Tensor]]:
        """Stream ``(pc, sn, node)`` microbatches through both stages:
        ``(keypoints, sigmas, descriptors)`` of each, on the stages'
        devices. Every launch of both stages is queued before anything is
        waited for. ``priorities[i]`` (``(B, N)``) are microbatch i's ball
        priorities (the tests pass usip_tpu's), else drawn from
        ``generator``."""
        out = []
        if self.streams is None:
            for i, (pc, sn, node) in enumerate(microbatches):
                kp, sig = self._detect(pc.to(self.d0), sn.to(self.d0),
                                       node.to(self.d0))
                pri = None if priorities is None else priorities[i]
                d, _ = self.descriptor(pc.to(self.d1), sn.to(self.d1), kp,
                                       pri, generator=generator)
                out.append((kp, sig, d))
            return out
        s0, s1 = self.streams
        main0 = torch.cuda.current_stream(self.d0)
        main1 = torch.cuda.current_stream(self.d1)
        s0.wait_stream(main0)
        s1.wait_stream(main1)
        for i, (pc, sn, node) in enumerate(microbatches):
            with torch.cuda.stream(s0):
                pc0, sn0, node0 = (t.to(self.d0, non_blocking=True)
                                   for t in (pc, sn, node))
                kp, sig = self._detect(pc0, sn0, node0)
                done = torch.cuda.Event()
                done.record(s0)
            with torch.cuda.stream(s1):
                s1.wait_event(done)
                # the handoff: only the keypoints cross (the cloud, when
                # the stages share a card, is the stage-0 copy)
                kp1 = kp.to(self.d1, non_blocking=True)
                pc1 = pc0.to(self.d1, non_blocking=True)
                sn1 = sn0.to(self.d1, non_blocking=True)
                for t in (kp, pc0, sn0, kp1, pc1, sn1):
                    if t.device == self.d1:
                        t.record_stream(s1)
                pri = None if priorities is None else \
                    priorities[i].to(self.d1, non_blocking=True)
                d, _ = self.descriptor(pc1, sn1, kp1, pri,
                                       generator=generator)
            for t in (kp, sig):
                t.record_stream(s0)
            out.append((kp, sig, d))
        main0.wait_stream(s0)
        main1.wait_stream(s1)
        return out


def pipeline_detect_describe(cfg: Config, detector, descriptor, microbatches,
                             priorities: Optional[Sequence[Tensor]] = None,
                             devices: Optional[Sequence] = None,
                             generator: Optional[torch.Generator] = None
                             ) -> List[Tuple[Tensor, Tensor, Tensor]]:
    """Build a ``DetectDescribePipeline`` and run it once."""
    return DetectDescribePipeline(cfg, detector, descriptor, devices)(
        microbatches, priorities, generator)


def sequential_detect_describe(cfg: Config, detector, descriptor,
                               microbatches, priorities=None,
                               generator: Optional[torch.Generator] = None):
    """The same work on one stream of the detector's device, each
    microbatch detected then described: the pipeline's reference."""
    dev = next(detector.parameters()).device
    chain = prepare_chain(*fusion_chain_params(detector.knnlayer_1))
    out = []
    with torch.no_grad():
        for i, (pc, sn, node) in enumerate(microbatches):
            pc, sn, node = (t.to(dev) for t in (pc, sn, node))
            _, kp, sig = detector_infer_fused(detector.eval(), pc, sn, node,
                                              chain)
            pri = None if priorities is None else priorities[i].to(dev)
            d, _ = descriptor.eval()(pc, sn, kp, pri, generator=generator)
            out.append((kp, sig, d))
    return out


__all__ = ["DetectDescribePipeline", "pipeline_detect_describe",
           "sequential_detect_describe"]
