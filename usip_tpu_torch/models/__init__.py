"""Detector and descriptor models, and the detector's fused eval forward."""

from usip_tpu_torch.models.descriptor import Descriptor
from usip_tpu_torch.models.detector import Detector

__all__ = ["Descriptor", "Detector"]
