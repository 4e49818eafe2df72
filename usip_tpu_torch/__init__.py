"""usip_tpu_torch: the PyTorch/CUDA port of usip_tpu for one NVIDIA H100.

The JAX package ``usip_tpu`` is the reference this port is held against.
This package imports ``torch`` and never ``jax``; it reuses the reference's
jax-free host modules (``usip_tpu.config``, ``usip_tpu.data.common``,
``usip_tpu.eval.export``).
"""

__version__ = "0.1.0"
