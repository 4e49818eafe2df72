"""The numbers that decide ``correct``: a training run's worst-leaf gaps
and loss gaps against the reference, and a keypoint set's gaps."""

from __future__ import annotations

from typing import Dict, Iterable, List, Set

import torch

# a leaf whose first gradient in the reference is under this share of the
# median leaf's is nought to rounding (a bias before a train-mode
# BatchNorm): Adam moves it by round-off alone, so its change is left out
NOUGHT = 1e-3


def norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in leaves.items()}


def median(values: Iterable[float]) -> float:
    v = sorted(values)
    n = len(v)
    return 0.5 * (v[(n - 1) // 2] + v[n // 2])


def moving_leaves(ref_first_grads: Dict[str, torch.Tensor]) -> Set[str]:
    """The leaves the comparison counts: those whose reference gradient is
    at least ``NOUGHT`` of the median leaf's."""
    g = norms(ref_first_grads)
    floor = NOUGHT * median(g.values())
    return {k for k, v in g.items() if v >= floor}


def worst_leaf_gap(prog: Dict[str, torch.Tensor],
                   ref: Dict[str, torch.Tensor], keep: Set[str]) -> float:
    """Over the leaves ``keep``: the gap between the program's norm and
    the reference's, over the larger of the reference leaf's norm and the
    median leaf's; the worst leaf's."""
    p, r = norms({k: prog[k] for k in keep}), norms({k: ref[k] for k in keep})
    med = median(r.values())
    return max(abs(p[k] - r[k]) / max(r[k], med, 1e-30) for k in keep)


def loss_gap(prog: List[float], ref: List[float]) -> float:
    """The worst step's ``|loss - reference| / |reference|``."""
    return max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(prog, ref))


def keypoint_gaps(kp: torch.Tensor, sig: torch.Tensor, kp_ref: torch.Tensor,
                  sig_ref: torch.Tensor, anchor_ref: torch.Tensor
                  ) -> Dict[str, float]:
    """Keypoints ``(C, M, 3)`` and sigmas ``(C, M)`` of C clouds, each
    cloud's answer judged on its own against the reference's, in units of
    what the weights make of the cloud (so that seeds whose weights move
    keypoints further, or spread the sigmas wider, read alike): the median
    keypoint distance from the reference's over the mean offset of the
    reference's keypoints from their nodes' means ``anchor_ref`` (a median,
    since a neighbour set that a near-tie of distances decides moves a
    node's keypoint alone); the mean ``|log sigma - log sigma_ref|`` over
    the spread (standard deviation) of ``log sigma_ref``. The worst
    cloud's of each."""
    kp, sig = kp.double(), sig.double()
    kp_ref, sig_ref = kp_ref.double(), sig_ref.double()
    offset = (kp_ref - anchor_ref.double()).norm(dim=-1).mean(1)
    per_kp = (kp - kp_ref).norm(dim=-1).median(1).values / offset
    log_ref = sig_ref.log()
    per_sig = ((sig.log() - log_ref).abs().mean(1)
               / log_ref.std(dim=1).clamp_min(1e-12))
    return {"keypoint_gap": float(per_kp.max()),
            "sigma_gap": float(per_sig.max())}
