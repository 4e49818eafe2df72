"""Detector model and its fused eval forward."""

from usip_tpu_torch.models.detector import Detector

__all__ = ["Detector"]
