"""Process groups for data-parallel training on ``torch.distributed``
(counterpart of ``usip_tpu/parallel/mesh.py``).

usip_tpu runs one SPMD program over a device mesh: the batch sharded, the
state replicated, XLA inserting the gradient all-reduce. The port runs one
process a GPU (a rank), each holding the whole state and its rows of the
global batch; the collectives are explicit:

* a ``Mesh`` is one axis of ranks: its process group, this rank's place on
  it and this rank's device (``cuda:LOCAL_RANK``, or the CPU);
* ``make_mesh`` is the 1-D data axis over every rank; ``make_grid`` cuts
  the ranks into a 2-D ``data x points`` or ``data x channels`` grid, one
  process group for each row and each column;
* ``shard_batch`` keeps this rank's rows of a global batch, ``replicate``
  broadcasts rank 0's state;
* the autograd collectives of ``parallel/collectives.py`` carry BatchNorm's
  statistics and the losses' inputs across ranks.

Backends: NCCL on CUDA (one GPU a rank), gloo on the CPU (the tests) and,
asked for by name, on CUDA tensors (ranks sharing one GPU, where NCCL refuses
two ranks on one device).
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Any, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

# torchrun's coordination environment: a process started with it is one
# rank of a multi-process job, and a failed init must raise
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


class Mesh(NamedTuple):
    """One axis of ranks. ``group`` is its process group (None: the default
    group, every rank), ``ranks`` the global ranks on it in axis order,
    ``device`` this rank's device."""
    group: Any
    ranks: Sequence[int]
    device: torch.device

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def rank(self) -> int:
        """This rank's place on the axis."""
        return list(self.ranks).index(global_rank())


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def global_rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def is_main_process() -> bool:
    """Rank 0 writes checkpoints, metrics and snapshots (usip_tpu's
    ``jax.process_index() == 0``)."""
    return global_rank() == 0


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           device="cuda",
                           timeout: Optional[float] = None) -> None:
    """Join the process group of a multi-process run.

    With ``coordinator_address`` (``host:port``, or an ``init_method`` URL
    such as ``tcp://host:port`` or ``file:///path``), ``num_processes`` and
    ``process_id``: that group, its rank ``process_id``. Without them, under
    torchrun (``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT`` set):
    torchrun's group. Otherwise there is no coordination environment and the
    process stays single-process, said in the log (usip_tpu's rule). A
    failed init raises: N processes must never train on alone.

    ``backend`` defaults to NCCL for a CUDA ``device`` and gloo for the CPU;
    ``timeout`` (seconds) bounds every collective's wait (torch's default
    where None).
    """
    backend = backend or default_backend(device)
    extra = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=timeout)}
    if is_distributed():
        return
    if coordinator_address is None and num_processes is None:
        if not all(os.environ.get(k) for k in _TORCHRUN_ENV):
            logging.getLogger(__name__).info(
                "initialize_distributed: no coordination environment "
                "detected (%s unset); staying single-process",
                "/".join(_TORCHRUN_ENV))
            return
        _set_device(device, int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, init_method="env://", **extra)
        return
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("pass coordinator_address, num_processes and "
                         "process_id together")
    url = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    _set_device(device, int(os.environ.get("LOCAL_RANK", process_id)))
    dist.init_process_group(backend, init_method=url,
                            world_size=int(num_processes),
                            rank=int(process_id), **extra)


def _set_device(device, local_rank: int) -> None:
    if torch.device(device).type == "cuda" and torch.cuda.is_available():
        torch.cuda.set_device(local_rank % torch.cuda.device_count())


def local_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` (modulo the visible cards, so
    that ranks sharing one card share it), or the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' asked for, but CUDA is not "
                           "available")
    if dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", global_rank()))
    index = local % torch.cuda.device_count()
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def make_mesh(num_devices: Optional[int] = None, device="cuda") -> Mesh:
    """The 1-D data axis over every rank (``num_devices``, where given,
    must be the world size)."""
    n = world_size()
    if num_devices is not None and num_devices != n:
        raise ValueError(f"make_mesh({num_devices}): the process group has "
                         f"{n} ranks (one device a rank)")
    return Mesh(None, tuple(range(n)), local_device(device))


def make_grid(dp: int, other: int, device="cuda"):
    """A ``dp x other`` grid over ``dp * other`` ranks, rank ``d * other +
    j`` at row d, column j (JAX's ``devices.reshape(dp, other)``). Returns
    this rank's ``(data mesh, other mesh)``: the ranks of its column on
    the data axis, of its row on the other (``points`` or ``channels``).
    Every rank creates every group, in the same order (torch's rule for
    ``new_group``)."""
    n = world_size()
    if dp * other != n:
        raise ValueError(f"a {dp} x {other} grid needs {dp * other} ranks; "
                         f"the process group has {n}")
    dev = local_device(device)
    me = global_rank()
    data_mesh = axis_mesh = None
    for j in range(other):
        ranks = tuple(d * other + j for d in range(dp))
        group = dist.new_group(list(ranks)) if n > 1 else None
        if me in ranks:
            data_mesh = Mesh(group, ranks, dev)
    for d in range(dp):
        ranks = tuple(d * other + j for j in range(other))
        group = dist.new_group(list(ranks)) if n > 1 else None
        if me in ranks:
            axis_mesh = Mesh(group, ranks, dev)
    return data_mesh, axis_mesh


def batch_sharding(mesh: Mesh, batch_size: int) -> slice:
    """This rank's rows of a global batch of ``batch_size``: the leading
    axis cut into ``mesh.size`` equal blocks, in rank order."""
    if batch_size % mesh.size:
        raise ValueError(f"batch of {batch_size} does not split over "
                         f"{mesh.size} ranks")
    b = batch_size // mesh.size
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def replicated(mesh: Mesh) -> torch.device:
    """Where replicated state lives on this rank: its device (every rank
    holds a whole copy)."""
    return mesh.device


def shard_batch(mesh: Mesh, batch: Any) -> Any:
    """This rank's rows of a global batch (a tensor, array, tuple,
    NamedTuple or dict of them, leading batch axis).

    A multi-process run with per-rank loading hands each rank its rows
    already (the engines' loaders); this cuts a batch that every rank
    holds whole."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    if isinstance(batch, tuple):
        parts = [shard_batch(mesh, v) for v in batch]
        return type(batch)(*parts) if hasattr(batch, "_fields") \
            else tuple(parts)
    if batch is None or not hasattr(batch, "shape") or batch.ndim == 0:
        return batch
    return batch[batch_sharding(mesh, batch.shape[0])]


@torch.no_grad()
def replicate(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank of ``mesh``
    (in place; returns ``module``). Same-seed initialisation or the same
    checkpoint gives every rank the same values already; this makes it
    so."""
    if mesh.size > 1:
        src = mesh.ranks[0]
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src, group=mesh.group)
    return module


def jit_train_step(step_fn, mesh: Mesh, donate_state: bool = True):
    """usip_tpu jits a step for the mesh; the port's steps run eagerly and
    take the mesh when they are made (``make_detector_train_step(cfg,
    mesh=...)``), so the step comes back as it is."""
    del mesh, donate_state
    return step_fn


def broadcast_object(obj, mesh: Optional[Mesh] = None):
    """Rank 0's ``obj`` on every rank (pickled; host values only)."""
    if not is_distributed():
        return obj
    box = [obj]
    src = 0 if mesh is None else mesh.ranks[0]
    dist.broadcast_object_list(box, src=src,
                               group=None if mesh is None else mesh.group)
    return box[0]


def all_gather_object(obj, mesh: Mesh) -> list:
    """Every rank's ``obj`` in axis order (pickled; host values only)."""
    if mesh.size == 1:
        return [obj]
    out = [None] * mesh.size
    dist.all_gather_object(out, obj, group=mesh.group)
    return out
