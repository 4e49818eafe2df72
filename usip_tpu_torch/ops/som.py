"""Self-organizing-map node training and potential-field initialization
(counterpart of ``usip_tpu/ops/som.py``).

Offline node-precomputation utilities matching reference ``util/som.py:57-418``
(SOM/BatchSOM with gaussian grid-neighborhood batch updates) and
``util/potential_field.py`` (repulsion-based uniform node placement). The
released training configs take FPS nodes from the loaders instead (SURVEY.md
§2.2); these are the reference's documented node-initialization path.

Plain PyTorch in fp32 on an explicit device (default ``cuda``, which raises
without CUDA; the tests pass ``cpu``), vectorised over the batch, with
usip_tpu's arithmetic in usip_tpu's order: the distances are ``x^2 + n^2 -
2 x.n`` and the argmin takes the first of equal values. No kernel of the port
serves here: ``min_argmin`` computes ``p^2 - 2 p.n + n^2`` and clamps, which
would move near-ties away from usip_tpu's.
"""

from __future__ import annotations

import numpy as np
import torch

from usip_tpu_torch.device import resolve_device


def potential_field_init(node_num: int, dim: int = 3, iterations: int = 100,
                         learning_rate: float = 0.01, seed: int = 2017,
                         device="cuda") -> np.ndarray:
    """Repulsion-based uniform placement in [-1, 1]^dim
    (util/potential_field.py:11-86): inverse-square node-node forces + linear
    wall force, ``iterations`` gradient steps in fp32 on ``device``, then the
    row-major (x, then y) grid reorder on the host.

    Deterministic: the reference seeds numpy with 2017 for the init.
    """
    rng = np.random.RandomState(seed)
    node = rng.rand(node_num, dim) * 2 - 1
    nodes = torch.as_tensor(node, dtype=torch.float32,
                            device=resolve_device(device))
    for _ in range(iterations):
        # node-node: f(src->dst) = (dst - src) / |d|^3   (:21-26)
        diff = nodes[:, None, :] - nodes[None, :, :]          # (M, M, D)
        norm = torch.linalg.vector_norm(diff, dim=-1) + 1e-5
        force = torch.sum(diff / (norm ** 3)[..., None], dim=1)
        # wall: -x * node_num / 1.5 per axis where |x| >= 0.01  (:28-39)
        wall = torch.where(nodes.abs() < 0.01, 0.0,
                           -nodes * (node_num / 1.5))
        nodes = nodes + (force + wall) * learning_rate
    node = nodes.cpu().numpy()

    # grid reorder (:74-86): sort by x, reshape to rows x cols, sort rows by y
    rows = int(np.sqrt(node_num))
    cols = rows
    if rows * cols == node_num:
        node = node[node[:, 0].argsort()]
        node = node.reshape(rows, cols, dim)
        for i in range(rows):
            node[i] = node[i][node[i][:, 1].argsort()]
        node = node.reshape(node_num, dim)
    return node.astype(np.float32)


def _grid_weighting(rows: int, cols: int, sigma: float) -> np.ndarray:
    """Gaussian grid-neighborhood weights (node_num, rows, cols)
    (util/som.py:97-120)."""
    n = rows * cols
    w = np.zeros((n, rows, cols), np.float32)
    d = 2 * np.pi * sigma * sigma
    for idx in range(n):
        ci, cj = idx // cols, idx % cols
        ax = np.exp(-np.power(np.arange(rows) - ci, 2) / d)
        ay = np.exp(-np.power(np.arange(cols) - cj, 2) / d)
        w[idx] = np.outer(ax, ay)
    return w


class SOMTrainer:
    """Batched SOM training (BatchSOM semantics, util/som.py:215-418).

    Usage::

        trainer = SOMTrainer(rows=8, cols=8, device="cuda")
        nodes = trainer.optimize(points)   # points (B, N, 3) -> nodes (B, M, 3)
    """

    def __init__(self, rows: int = 8, cols: int = 8, dim: int = 3,
                 sigma: float = 0.4, learning_rate: float = 0.5,
                 max_iteration: int = 60, device="cuda"):
        self.device = resolve_device(device)
        self.rows, self.cols, self.dim = rows, cols, dim
        self.node_num = rows * cols
        self.sigma = sigma
        self.learning_rate = learning_rate
        self.max_iteration = max_iteration
        self._init_w = torch.from_numpy(
            _grid_weighting(rows, cols, sigma)).to(self.device)
        self._init_nodes = torch.from_numpy(
            potential_field_init(self.node_num, dim,
                                 device=self.device)).to(self.device)

    def _weighting(self, sigma: torch.Tensor) -> torch.Tensor:
        """w^(sigma0/sigma)^2 from the precomputed base (util/som.py:108-111)."""
        scale = 1.0 / ((sigma / self.sigma) ** 2)
        return torch.exp(torch.log(self._init_w + 1e-30) * scale)

    def _update(self, nodes: torch.Tensor, x: torch.Tensor,
                iteration: torch.Tensor) -> torch.Tensor:
        """One batch update. nodes (B, M, D), x (B, N, D)."""
        b, m = x.shape[0], self.node_num
        lr = self.learning_rate / (1 + 2 * iteration / self.max_iteration)
        sigma = self.sigma / (1 + 2 * iteration / self.max_iteration)

        d2 = (torch.sum(x ** 2, 2)[:, :, None]
              + torch.sum(nodes ** 2, 2)[:, None]
              - 2 * x @ nodes.transpose(1, 2))                  # (B, N, M)
        ids = torch.argmin(d2, dim=2)                            # (B, N)
        flat = (ids + m * torch.arange(b, device=x.device)[:, None]).reshape(-1)
        counts = torch.zeros(b * m, device=x.device).index_add_(
            0, flat, torch.ones_like(flat, dtype=torch.float32)
        ).reshape(b, m) + 1e-5
        occupied = (counts > 1e-4 + 1e-5).to(torch.float32)
        sums = torch.zeros(b * m, self.dim, device=x.device).index_add_(
            0, flat, x.reshape(-1, self.dim)).reshape(b, m, self.dim)
        means = sums / counts[:, :, None]                        # (B, M, D)
        # per-node pull of every node toward occupied cluster means,
        # gaussian-weighted on the SOM grid (util/som.py:346-396)
        diff = means[:, :, None, :] - nodes[:, None, :, :]       # (B, M_mean, M_node, D)
        diff = diff * occupied[:, :, None, None]
        w = self._weighting(sigma).reshape(m, m)                 # (M_mean, M_node)
        delta = torch.sum(diff * w[None, :, :, None], dim=1) * lr
        return nodes + delta

    @torch.no_grad()
    def optimize(self, x) -> torch.Tensor:
        """Full schedule: max_iteration/3 warmup steps at iter=0, then the
        annealed loop (util/som.py:205-211). x (B, N, D), an array or a
        tensor, goes to the trainer's device in fp32 -> nodes (B, M, D)."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        b = x.shape[0]
        nodes = self._init_nodes.expand(b, self.node_num, self.dim)
        zero = torch.zeros((), device=self.device)
        for _ in range(self.max_iteration // 3):
            nodes = self._update(nodes, x, zero)
        for it in range(self.max_iteration):
            nodes = self._update(nodes, x,
                                 torch.full((), float(it), device=self.device))
        return nodes
