"""Exact smallest-k selection (port of ``usip_tpu/ops/topk.py``).

usip_tpu dispatches among three bit-identical forms: ``lax.top_k``, a
two-stage chunked ``top_k``, and the Mosaic kernel for long fp32 rows on a
TPU. The port has one form: the smallest-k kernel (``ops.kernels.smallest_k``,
``csrc/smallest_k.cu``) for CUDA tensors and its plain version, a stable sort,
for CPU tensors. This is the selection behind the knn grouping and the exact
ball query.
"""

from __future__ import annotations

from typing import Tuple

import torch

from usip_tpu_torch.ops import kernels

Tensor = torch.Tensor


def smallest_k(scores: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """The k smallest entries of the last axis of ``scores (..., N)``:
    ``(values ascending fp32, indices int32)``, each ``(..., k)``.

    Bit-identical to ``lax.top_k(-scores, k)`` negated, ties to the lowest
    index, for scores that are finite or +inf (+inf entries come last, in
    index order: the ball query's "outside the radius"). Like
    ``smallest_k_pallas``, -inf and NaN count as absent and come back as
    +inf, and picks past the row's end are clamped to N-1. Any float dtype is
    taken as fp32; the values are differentiable, the gradient coming back in
    the input's dtype.
    """
    return kernels.SmallestK.apply(scores, k)
