"""usip_tpu_torch: the PyTorch/CUDA port of usip_tpu for one NVIDIA H100.

The JAX package ``usip_tpu`` is the reference this port is held against.
This package imports ``torch`` and never ``jax``, and nothing of
``usip_tpu``: it keeps its own copies of the host code it needs
(``config``, ``data.common``, ``eval.export``), laid out where they sit in
``usip_tpu``.
"""

__version__ = "0.1.0"
