"""``usip_tpu_torch.ops.som`` against ``usip_tpu.ops.som`` on the CPU.

The same numpy inputs go through both packages' potential-field init and
SOM trainer (fp32 both; usip_tpu under XLA on the CPU, the port in plain
PyTorch). The arithmetic is the same in the same order, but the two
libraries sum and multiply in their own orders, so floats agree to fp32
noise, not bit for bit:
* ``potential_field_init``: nodes within ``PF_TOL`` (100 steps of the
  repulsion dynamics; measured 1.5e-6 at 64 nodes);
* ``SOMTrainer.optimize`` on tie-free inputs (every point's nearest and
  second-nearest final node apart by more than ``GAP``): every point's
  final node (ids) equal, nodes within ``SOM_TOL`` (measured 4.8e-7).
The grid weights and the trainer's initial nodes are the same numbers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from usip_tpu.ops import som as jax_som
from usip_tpu_torch.ops import som

PF_TOL = 1e-5
SOM_TOL = 1e-5
# tie-free: the nodes' fp32 noise (< 1e-6) moves a squared distance by a few
# 1e-6 here; a point whose two nearest nodes lie further apart keeps its node
GAP = 2e-5


@pytest.mark.parametrize("node_num,dim,iterations",
                         [(16, 2, 60), (64, 3, 100), (25, 3, 100),
                          (10, 3, 40)])
def test_potential_field_matches_usip_tpu(node_num, dim, iterations):
    """Square counts get the grid reorder, others (10) keep the order."""
    ref = jax_som.potential_field_init(node_num, dim, iterations=iterations)
    ours = som.potential_field_init(node_num, dim, iterations=iterations,
                                    device="cpu")
    assert ours.dtype == ref.dtype == np.float32
    assert ours.shape == ref.shape == (node_num, dim)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=PF_TOL)


def test_grid_weighting_and_init_nodes_equal_usip_tpu():
    np.testing.assert_array_equal(som._grid_weighting(8, 8, 0.4),
                                  jax_som._grid_weighting(8, 8, 0.4))
    trainer = som.SOMTrainer(rows=4, cols=4, device="cpu")
    np.testing.assert_array_equal(trainer._init_nodes.numpy(),
                                  som.potential_field_init(16, 3,
                                                           device="cpu"))


def _blobs(seed, b, n):
    """b clouds of two gaussian blobs each, at seeded centres."""
    rng = np.random.default_rng(seed)
    clouds = []
    for _ in range(b):
        c = rng.uniform(-0.8, 0.8, size=(2, 3))
        pts = np.concatenate([rng.normal(c[0], 0.15, size=(n // 2, 3)),
                              rng.normal(c[1], 0.15, size=(n - n // 2, 3))])
        clouds.append(pts)
    return np.stack(clouds).astype(np.float32)


def _ids_and_gap(x, nodes):
    """Each point's nearest node (float64) and the smallest gap between a
    point's nearest and second-nearest node distance."""
    d = ((x[:, :, None, :].astype(np.float64)
          - nodes[:, None, :, :].astype(np.float64)) ** 2).sum(-1)
    two = np.sort(d, axis=-1)[..., :2]
    return np.argmin(d, axis=-1), float((two[..., 1] - two[..., 0]).min())


@pytest.mark.parametrize("rows,cols,iters,b,n,seed",
                         [(4, 4, 30, 3, 400, 0), (8, 8, 60, 2, 1000, 6),
                          (3, 5, 12, 4, 256, 0)])
def test_som_trainer_matches_usip_tpu(rows, cols, iters, b, n, seed):
    x = _blobs(seed, b, n)
    ref = np.asarray(jax_som.SOMTrainer(rows=rows, cols=cols,
                                        max_iteration=iters)
                     .optimize(jnp.asarray(x)))
    trainer = som.SOMTrainer(rows=rows, cols=cols, max_iteration=iters,
                             device="cpu")
    ours = trainer.optimize(x)
    assert ours.dtype == torch.float32 and ours.device.type == "cpu"
    ours = ours.numpy()
    assert ours.shape == ref.shape == (b, rows * cols, 3)
    ids_ref, gap = _ids_and_gap(x, ref)
    assert gap > GAP, "the input must be tie-free at the final nodes"
    ids, _ = _ids_and_gap(x, ours)
    np.testing.assert_array_equal(ids, ids_ref)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=SOM_TOL)
    # the trained nodes moved toward the data (usip_tpu's own check)
    d = np.linalg.norm(x[:, :, None] - ours[:, None], axis=-1).min(-1)
    d0 = np.linalg.norm(x[:, :, None] - trainer._init_nodes.numpy()[None,
                                                                    None],
                        axis=-1).min(-1)
    assert d.mean() < d0.mean()


def test_som_trainer_takes_tensors_and_batches_independently():
    """A tensor input gives the array input's nodes, and each cloud of a
    batch gets the nodes it gets alone (the batch is vectorised, not
    coupled)."""
    x = _blobs(3, 3, 300)
    trainer = som.SOMTrainer(rows=4, cols=4, max_iteration=9, device="cpu")
    batch = trainer.optimize(torch.from_numpy(x))
    assert torch.equal(batch, trainer.optimize(x))
    for i in range(3):
        np.testing.assert_allclose(batch[i:i + 1].numpy(),
                                   trainer.optimize(x[i:i + 1]).numpy(),
                                   rtol=0, atol=1e-6)


def test_cuda_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        som.SOMTrainer(rows=2, cols=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        som.potential_field_init(4)
