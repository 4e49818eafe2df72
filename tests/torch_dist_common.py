"""Ranks for the port's multi-rank CPU tests: ``run_ranks`` starts R gloo
ranks with ``torch.multiprocessing`` (a ``file://`` rendezvous in the test's
temporary directory, so that parallel test workers never race for a port),
runs one worker function of this module in each, and returns each rank's
result. This module imports torch and the port only: a spawned rank never
imports JAX."""

from __future__ import annotations

import contextlib
import os
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# seconds a rank waits in a collective before it fails (a rank that died
# must not leave the other waiting for torch's default half hour)
RANK_TIMEOUT = 120


# the train-mode BatchNorm stages that ``nn/layers.py _TrainBatchNorm``
# calls through ``ops/kernels.py``
BN_STAGES = ("batch_norm_stats", "batch_norm_finalise", "batch_norm_apply",
             "batch_norm_backward_reduce", "batch_norm_backward_apply")


@contextlib.contextmanager
def plain_bn_stages():
    """``_TrainBatchNorm`` on CPU tensors: the kernels' wrappers (CUDA
    only) stand replaced by their plain stages while the block runs."""
    from usip_tpu_torch.ops import kernels
    saved = {n: getattr(kernels, n) for n in BN_STAGES}
    try:
        for n in BN_STAGES:
            setattr(kernels, n, getattr(kernels, n + "_plain"))
        yield
    finally:
        for n, fn in saved.items():
            setattr(kernels, n, fn)


def _entry(rank: int, world: int, root: str, fn, args) -> None:
    torch.set_num_threads(1)
    out = os.path.join(root, f"rank{rank}.pt")
    try:
        from usip_tpu_torch.parallel import initialize_distributed
        initialize_distributed(f"file://{os.path.join(root, 'rdzv')}", world,
                               rank, backend="gloo", device="cpu",
                               timeout=RANK_TIMEOUT)
        result = fn(rank, world, *args)
        dist.barrier()
        torch.save({"ok": result}, out)
    except BaseException:  # the parent reports the rank's traceback
        torch.save({"error": traceback.format_exc()}, out)
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, root: str, *args):
    """``fn(rank, world, *args)`` in ``world`` gloo ranks on the CPU; the
    list of their return values (torch-saveable), rank by rank."""
    os.makedirs(root, exist_ok=True)
    try:
        mp.start_processes(_entry, args=(world, root, fn, args),
                           nprocs=world, start_method="spawn")
    except (mp.ProcessRaisedException, mp.ProcessExitedException):
        pass
    results = []
    for r in range(world):
        path = os.path.join(root, f"rank{r}.pt")
        res = torch.load(path, weights_only=False) if os.path.exists(path) \
            else {"error": f"rank {r} wrote no result"}
        if "error" in res:
            raise AssertionError(f"rank {r} failed:\n{res['error']}")
        results.append(res["ok"])
    return results


def param_hash(module: torch.nn.Module) -> str:
    """A hash of every parameter and buffer, bit for bit."""
    import hashlib
    h = hashlib.sha256()
    for name, t in sorted(module.state_dict().items()):
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _grads(model: torch.nn.Module) -> dict:
    return {n: p.grad.clone() for n, p in model.named_parameters()
            if p.grad is not None}


def _state(model: torch.nn.Module) -> dict:
    return {k: v.clone() for k, v in model.state_dict().items()}


# --------------------------------------------- data-parallel checks ----

def parallel_checks(rank: int, world: int, p: dict) -> dict:
    """The data-parallel checks of tests/test_torch_parallel.py at
    ``world`` ranks: the mesh, BatchNorm over the ranks, the detector and
    descriptor steps, both engines and the export."""
    from usip_tpu_torch.config import get_config
    from usip_tpu_torch.models import Descriptor, Detector
    from usip_tpu_torch.nn.layers import BatchNorm
    from usip_tpu_torch.parallel import (batch_sharding, make_mesh, replicate,
                                         shard_batch)
    from usip_tpu_torch.train import TrainState, steps

    out = {}
    mesh = make_mesh(world, device="cpu")
    out["mesh"] = (mesh.size, mesh.rank, batch_sharding(mesh, 8))
    out["shard"] = shard_batch(mesh, {"x": torch.arange(8), "n": None})["x"]
    torch.manual_seed(rank)
    net = torch.nn.Linear(3, 2)
    replicate(mesh, net)
    out["replicate"] = param_hash(net)

    # BatchNorm over the ranks' rows: forward, backward, statistics
    x = p["bn_x"][batch_sharding(mesh, p["bn_x"].shape[0])].clone()
    x.requires_grad_(True)
    bn = BatchNorm(x.shape[-1], process_group=mesh).train()
    bn.momentum = 0.3
    with torch.no_grad():
        bn.weight.copy_(p["bn_w"])
        bn.bias.copy_(p["bn_b"])
    y = bn(x)
    w_up = p["bn_up"][batch_sharding(mesh, p["bn_up"].shape[0])]
    (y * w_up).sum().backward()
    from usip_tpu_torch.parallel.collectives import all_reduce_grads
    all_reduce_grads(bn.parameters(), mesh)
    out["bn"] = {"y": y.detach(), "dx": x.grad, "dw": bn.weight.grad,
                 "db": bn.bias.grad, "mean": bn.running_mean.clone(),
                 "var": bn.running_var.clone()}
    # the same rows through the CUDA route's autograd Function (its plain
    # stages here), its all-reduces over the mesh's default group
    from usip_tpu_torch.nn.layers import _TrainBatchNorm
    x = p["bn_x"][batch_sharding(mesh, p["bn_x"].shape[0])].clone()
    x.requires_grad_(True)
    bn = BatchNorm(x.shape[-1], process_group=mesh).train()
    bn.momentum = 0.3
    with torch.no_grad():
        bn.weight.copy_(p["bn_w"])
        bn.bias.copy_(p["bn_b"])
    with plain_bn_stages():
        y = _TrainBatchNorm.apply(x, bn.weight, bn.bias, bn, False)
        (y * w_up).sum().backward()
    all_reduce_grads(bn.parameters(), mesh)
    out["bn_function"] = {"y": y.detach(), "dx": x.grad,
                          "dw": bn.weight.grad, "db": bn.bias.grad,
                          "mean": bn.running_mean.clone(),
                          "var": bn.running_var.clone()}

    # the detector's step on this rank's rows with the global draws
    d = p["det"]
    cfg = get_config("kitti", **d["overrides"])
    det = Detector(cfg.detector)
    det.load_state_dict(d["state_dict"])
    state = TrainState.create(det, cfg.train.lr)
    batch = shard_batch(mesh, steps.ParentBatch(d["pc"], d["sn"]))
    m = steps.make_detector_train_step(cfg, mesh)(state, batch, d["epoch"],
                                                  draws=d["draws"])
    out["det"] = {"metrics": {k: float(v) for k, v in m.items()},
                  "grads": _grads(det), "state": _state(det),
                  "hash": param_hash(det)}
    # the eval step on the same rows, from the same weights
    det.load_state_dict(d["state_dict"])
    m = steps.make_detector_eval_step(cfg, mesh)(state, batch,
                                                 draws=d["eval_draws"])
    out["det_eval"] = {k: float(v) for k, v in m.items()}

    # the descriptor's step
    for name in ("scan", "cgf"):
        d = p[name]
        cfg = get_config("kitti", role="descriptor", **d["overrides"])
        det = Detector(cfg.detector)
        det.load_state_dict(d["det"])
        desc = Descriptor(cfg.descriptor)
        desc.load_state_dict(d["desc"])
        state = TrainState.create(desc, cfg.train.lr)
        anc, anc_sn, pos, pos_sn, neg = d["batch"]
        batch = steps.DescriptorBatch(*shard_batch(
            mesh, (anc, anc_sn, pos, pos_sn)), neg)
        m = steps.make_descriptor_train_step(cfg, name == "cgf", mesh=mesh)(
            state, det, batch, d["epoch"], draws=d["draws"])
        out[name] = {"metrics": {k: float(v) for k, v in m.items()},
                     "grads": _grads(desc), "state": _state(desc),
                     "hash": param_hash(desc)}
    out["engines"] = _engine_checks(p["engine"])
    out["export"] = _export_checks(p["export"])
    return out


def _engine_checks(p: dict) -> dict:
    """Both engines for one epoch at the world size, the detector's
    resumed for a second."""
    from usip_tpu_torch.config import get_config
    from usip_tpu_torch.data.pipeline import BatchLoader
    from usip_tpu_torch.data.synthetic import SyntheticDataset
    from usip_tpu_torch.parallel.mesh import global_rank
    from usip_tpu_torch.train.descriptor_loop import DescriptorEngine
    from usip_tpu_torch.train.loop import DetectorEngine

    cfg = get_config("kitti", **p["overrides"])
    shard = (global_rank(), cfg.train.num_devices)

    def loader(seed, size):
        ds = SyntheticDataset(size=size, input_pc_num=cfg.data.input_pc_num,
                              surface_normal_len=4, seed=seed)
        return BatchLoader(ds, cfg.train.batch_size, shuffle=seed == 0,
                           num_workers=1, shard=shard)

    out_dir = os.path.join(p["root"], "det")
    eng = DetectorEngine(cfg, loader(0, 8), loader(1, 4), out_dir=out_dir,
                         device="cpu")
    eng.fit(epochs=1)
    first = param_hash(eng.state.model)
    eng2 = DetectorEngine(cfg, loader(0, 8), loader(1, 4), out_dir=out_dir,
                          device="cpu")
    start = eng2.resume(os.path.join(out_dir, "last.pt"))
    resumed = param_hash(eng2.state.model) == first
    eng2.fit(epochs=2)
    dcfg = get_config("kitti", role="descriptor", **p["desc_overrides"])
    deng = DescriptorEngine(dcfg, os.path.join(out_dir, "last.pt"),
                            synthetic=True,
                            out_dir=os.path.join(p["root"], "desc"),
                            device="cpu")
    deng.fit(epochs=1)
    return {"start": start, "resumed": resumed,
            "hash": param_hash(eng2.state.model),
            "desc_hash": param_hash(deng.state.model),
            "step": eng2.state.step, "desc_step": deng.state.step}


def _export_checks(p: dict) -> dict:
    """``run_export`` at the world size into ``<root>/ranks``."""
    from usip_tpu_torch.config import get_config
    from usip_tpu_torch.eval.export_runner import run_export
    cfg = get_config("kitti", **p["overrides"])
    draws = p["node_draws"]
    return [run_export(cfg, p["checkpoint"], os.path.join(p["root"], name),
                       desired_num=p["desired"], synthetic=True,
                       device="cpu", node_draws=fn)
            for name, fn in (("export_ranks", None),
                             ("export_ranks_drawn", lambda i: draws[i]))]


# ------------------------------------------------ point-sharded checks ----

def _points_shard(mesh, x, dim=1):
    from usip_tpu_torch.parallel.sharded_ops import shard_points
    return shard_points(mesh, x, dim).contiguous()


def sharded_checks(rank: int, world: int, p: dict) -> dict:
    """The checks of tests/test_torch_sharded.py at ``world`` ranks: the
    point-sharded ops, detector, train steps and describe, and tensor
    parallelism."""
    from usip_tpu_torch.config import get_config
    from usip_tpu_torch.models import Descriptor, Detector
    from usip_tpu_torch.parallel import sharded_ops as so
    from usip_tpu_torch.parallel.sharded_descriptor import sharded_describe
    from usip_tpu_torch.parallel.sharded_detector import (
        sharded_detector_forward)
    from usip_tpu_torch.parallel.sharded_train import (
        make_sharded_descriptor_train_step, make_sharded_detector_train_step,
        sharded_trunk_apply)
    from usip_tpu_torch.train import TrainState

    mesh = so.make_point_mesh(world, device="cpu")
    sh = lambda x, dim=1: _points_shard(mesh, x, dim)  # noqa: E731
    out = {}

    c = p["chamfer"]
    src = sh(c["src"]).requires_grad_(True)
    ch = so.sharded_chamfer_probabilistic(mesh, src, sh(c["dst"]),
                                          sh(c["ssig"]), sh(c["dsig"]))
    ch.loss.backward()
    out["chamfer"] = {"loss": ch.loss.detach(), "pure": ch.chamfer_pure,
                      "weighted": ch.chamfer_weighted, "grad": src.grad}

    s = p["single"]
    kp = s["kp"].clone().requires_grad_(True)
    d = so.sharded_single_side_chamfer(mesh, kp, sh(s["pc"]))
    d.sum().backward()
    out["single"] = {"d": d.detach(), "grad": kp.grad}
    out["min_dist"] = so.sharded_min_dist(s["kp"], sh(s["pc_tied"]), mesh)

    k = p["knn"]
    out["knn"] = so.sharded_knn_gather(mesh, k["q"], sh(k["db"]),
                                       sh(k["f"]), k["k"],
                                       return_indices=True)
    b = p["ball"]
    out["ball"] = [so.sharded_ball_gather(mesh, b["centers"], sh(b["pts"]),
                                          sh(b["feats"]), b["r"], b["k"],
                                          sh(pri), return_indices=True)
                   for pri in (b["pri"], b["pri_tied"])]

    t = p["detector"]
    cfg = get_config("modelnet", **t["overrides"])
    det = Detector(cfg.detector)
    det.load_state_dict(t["state_dict"])
    out["detector"] = sharded_detector_forward(
        mesh, cfg, det, sh(t["pc"]), sh(t["sn"]), t["node"])
    e = p["empty"]
    out["empty"] = {"trunk": sharded_trunk_apply(
        mesh, cfg, det, sh(e["pc"]), sh(e["sn"]), e["node"], train=False),
        "local_counts": _local_counts(sh(e["pc"]), e["node"])}

    tr = p["train"]
    det.load_state_dict(t["state_dict"])
    state = TrainState.create(det, 1e-3)
    args = [sh(x) if i in (0, 1, 3, 4) else x
            for i, x in enumerate(tr["args"])]
    m = make_sharded_detector_train_step(cfg, mesh)(state, *args, 0)
    out["train"] = {"metrics": {k_: float(v) for k_, v in m.items()},
                    "grads": _grads(det), "state": _state(det),
                    "hash": param_hash(det)}

    ds = p["describe"]
    for name in ("fp32", "global_bf16"):
        q = ds[name]
        dcfg = get_config(q["preset"], **q["overrides"])
        desc = Descriptor(dcfg.descriptor)
        desc.load_state_dict(q["state_dict"])
        out["describe_" + name] = sharded_describe(
            mesh, dcfg, desc, sh(q["pc"]), sh(q["sn"]), q["kp"],
            sh(q["priority"]))

    dt = p["desc_train"]
    dcfg = get_config("modelnet", **dt["overrides"])
    det = Detector(dcfg.detector)
    det.load_state_dict(dt["det"])
    desc = Descriptor(dcfg.descriptor)
    desc.load_state_dict(dt["desc"])
    state = TrainState.create(desc, 1e-3)
    a = dt["args"]
    m = make_sharded_descriptor_train_step(dcfg, mesh)(
        state, det, sh(a[0]), sh(a[1]), a[2], sh(a[3]), sh(a[4]), a[5], a[6],
        (sh(dt["pri"][0]), sh(dt["pri"][1])), 0)
    out["desc_train"] = {"metrics": {k_: float(v) for k_, v in m.items()},
                         "grads": _grads(desc), "state": _state(desc)}
    out["tp"] = _tp_checks(p["tp"], world)
    return out


def _local_counts(pc, node):
    from usip_tpu_torch.ops import assign_points_to_nodes
    return assign_points_to_nodes(pc, node).counts


def _tp_checks(p: dict, world: int, data_mesh=None, channel_mesh=None,
               rows=None) -> dict:
    """Tensor parallelism: the eval forward (fp32 and bf16, with cut
    params passed in) and one ``make_tp_train_step`` step over a
    ``shard_state_tp`` state."""
    from usip_tpu_torch.config import get_config
    from usip_tpu_torch.models import Detector
    from usip_tpu_torch.parallel import tensor_parallel as tpm
    from usip_tpu_torch.train import TrainState, steps

    mesh = channel_mesh or tpm.make_channel_mesh(world, device="cpu")
    out = {}
    for name in ("fp32", "bf16"):
        q = p[name]
        cfg = get_config("modelnet", **q["overrides"])
        det = Detector(cfg.detector)
        det.load_state_dict(q["state_dict"])
        out[name] = tpm.tensor_parallel_detector_forward(
            mesh, cfg, det, *q["inputs"])
        if name == "fp32":
            prepared = tpm.shard_tp_params(cfg, det, mesh.size, mesh.rank)
            out["prepared"] = tpm.tensor_parallel_detector_forward(
                mesh, cfg, det, *q["inputs"], tp_params=prepared)
    t = p["train"]
    cfg = get_config("kitti", **t["overrides"])
    det = Detector(cfg.detector)
    det.load_state_dict(t["state_dict"])
    state = tpm.shard_state_tp(mesh, TrainState.create(det, cfg.train.lr))
    batch = steps.ParentBatch(t["pc"], t["sn"])
    if data_mesh is not None:
        from usip_tpu_torch.parallel import shard_batch
        batch = shard_batch(data_mesh, batch)
    m = tpm.make_tp_train_step(cfg, data_mesh)(
        state, batch, t["epoch"], draws=t["draws"])
    out["train"] = {"metrics": {k: float(v) for k, v in m.items()},
                    "grads": _grads(state.model),
                    "layout": tpm.tp_state_sharding(
                        mesh, TrainState.create(det, cfg.train.lr)),
                    "params": {n: v.numel() for n, v in
                               state.model.named_parameters()}}
    return out


def grid_checks(rank: int, world: int, p: dict) -> dict:
    """The 2-D grids at 4 ranks: ``data x points`` sharded training (three
    steps) and ``data x channels`` tensor-parallel training (one step)."""
    from usip_tpu_torch.config import get_config
    from usip_tpu_torch.models import Detector
    from usip_tpu_torch.parallel import make_grid, shard_batch
    from usip_tpu_torch.parallel import tensor_parallel as tpm
    from usip_tpu_torch.parallel.sharded_train import (
        make_sharded_detector_train_step)
    from usip_tpu_torch.train import TrainState

    data, points = make_grid(2, 2, device="cpu")
    t = p["train"]
    cfg = get_config("modelnet", **t["overrides"])
    det = Detector(cfg.detector)
    det.load_state_dict(t["state_dict"])
    state = TrainState.create(det, 1e-3)
    args = [shard_batch(data, x) for x in t["args"]]
    args = [_points_shard(points, x) if i in (0, 1, 3, 4) else x
            for i, x in enumerate(args)]
    step = make_sharded_detector_train_step(cfg, points, data_mesh=data)
    losses = [float(step(state, *args, 0)["loss"]) for _ in range(3)]
    out = {"sp_losses": losses, "sp_hash": param_hash(det)}
    data, channels = tpm.make_dp_tp_mesh(2, 2, device="cpu")
    out["tp"] = _tp_checks(p["tp"], world, data, channels)["train"]
    return out
