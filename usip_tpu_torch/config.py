"""Configuration: the reference package's dataclass presets, shared as they
are (``usip_tpu/config.py`` imports no jax)."""

from usip_tpu.config import Config, DetectorConfig, get_config

__all__ = ["Config", "DetectorConfig", "get_config"]
