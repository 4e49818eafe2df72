"""Checkpoints of the port (counterpart of ``usip_tpu/train/checkpoint.py``).

The port's own format is a ``torch.save`` file (``.pt``) holding ``{"step",
"model", "optimizer"}``: the model's ``state_dict`` (parameters and
BatchNorm buffers, under the reference's names) and the Adam state, written
atomically through a ``.tmp`` rename, with a JSON sidecar (``<path>.json``)
holding the metadata the engines' ``resume`` reads (``epoch``, ``loss``,
``fit_samples``). The detector's and the descriptor's states are saved and
restored alike.

usip_tpu's checkpoints (``.msgpack``: flax ``serialization.to_bytes`` of
``{"step", "params", "batch_stats", "opt_state"}``) are read without flax or
msgpack by ``read_msgpack``, a decoder of the subset of msgpack that flax
writes. Their parameters and BatchNorm statistics load through
``weights.state_dict_from_jax``, and so do their Adam moments: optax's
``inject_hyperparams(adam)`` state (``opt_state.inner_state[0]``'s ``mu``,
``nu`` and ``count``, the injected ``learning_rate``, ``b1``, ``b2`` and
``eps``) becomes ``torch.optim.Adam``'s ``exp_avg``, ``exp_avg_sq`` and
``step`` a parameter and its group's ``lr``, ``betas`` and ``eps``, so a
resume from usip_tpu's checkpoint takes usip_tpu's next step.

``save_params_only`` / ``load_params_only`` are usip_tpu's inference-only
export: the port writes the model's ``state_dict`` (``.pt``) and reads
that or usip_tpu's params-only ``.msgpack`` (its ``params`` tree alone).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from usip_tpu_torch.weights import state_dict_from_jax

# flax's msgpack extension types (flax.serialization._MsgpackExtType)
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class _Reader:
    """Decoder of the msgpack subset flax writes: maps, arrays, str, bin,
    ints, floats, nil, bools and ext types (flax's ndarray, complex and
    numpy-scalar extensions)."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self.array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return self.take(t & 0x1F).decode("utf-8")
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in fixed:
            return fixed[t]
        sized = {  # tag: (kind, struct format of the length or value)
            0xC4: ("bin", "B"), 0xC5: ("bin", "H"), 0xC6: ("bin", "I"),
            0xC7: ("ext", "B"), 0xC8: ("ext", "H"), 0xC9: ("ext", "I"),
            0xCA: ("num", "f"), 0xCB: ("num", "d"),
            0xCC: ("num", "B"), 0xCD: ("num", "H"), 0xCE: ("num", "I"),
            0xCF: ("num", "Q"), 0xD0: ("num", "b"), 0xD1: ("num", "h"),
            0xD2: ("num", "i"), 0xD3: ("num", "q"),
            0xD9: ("str", "B"), 0xDA: ("str", "H"), 0xDB: ("str", "I"),
            0xDC: ("array", "H"), 0xDD: ("array", "I"),
            0xDE: ("map", "H"), 0xDF: ("map", "I"),
        }
        if t in sized:
            kind, fmt = sized[t]
            n = self.unpack(fmt)
            if kind == "num":
                return n
            if kind == "bin":
                return self.take(n)
            if kind == "str":
                return self.take(n).decode("utf-8")
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            return self.ext(self.unpack("b"), self.take(n))
        if 0xD4 <= t <= 0xD8:  # fixext 1, 2, 4, 8, 16
            code = self.unpack("b")
            return self.ext(code, self.take(1 << (t - 0xD4)))
        raise ValueError(f"msgpack tag 0x{t:02x} is not one flax writes")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    @staticmethod
    def ext(code: int, payload: bytes) -> Any:
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            arr = _ndarray_from_bytes(payload)
            return arr if code == _EXT_NDARRAY else arr[()]
        if code == _EXT_COMPLEX:
            re, im = _Reader(payload).value()
            return complex(re, im)
        raise ValueError(f"msgpack ext type {code} is not one flax writes")


def _ndarray_from_bytes(payload: bytes) -> np.ndarray:
    """flax's ndarray payload: a msgpack ``(shape, dtype name, C-order
    bytes)``. bfloat16 (which numpy lacks) is widened to float32."""
    shape, name, buf = _Reader(payload).value()
    if name == "bfloat16":
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(name)).reshape(shape).copy()


def read_msgpack(path: str) -> Dict[str, Any]:
    """A usip_tpu ``.msgpack`` checkpoint as nested dicts of numpy arrays,
    as ``flax.serialization.msgpack_restore`` gives it (flax splits leaves
    above 1 GiB into chunks, which a detector's never are; they are left
    as flax wrote them)."""
    with open(path, "rb") as f:
        reader = _Reader(f.read())
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{path}: trailing bytes after the msgpack object")
    return tree


def state_dict_from_msgpack(path: str) -> Tuple[Dict[str, torch.Tensor], int]:
    """The ``state_dict`` (a detector's or a descriptor's, as the tree
    says) and step count of a usip_tpu checkpoint."""
    payload = read_msgpack(path)
    return _model_state(payload), int(np.asarray(payload.get("step", 0)))


def _model_state(payload: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    return state_dict_from_jax({"params": payload["params"],
                                "batch_stats": payload.get("batch_stats",
                                                           {})})


def _load_adam(state, payload: Dict[str, Any]) -> None:
    """usip_tpu's optax Adam state (``payload["opt_state"]``) into
    ``state.optimizer``: each parameter's ``step``, ``exp_avg`` and
    ``exp_avg_sq`` on its device, and the groups' ``lr``, ``betas`` and
    ``eps``. The moments go through ``state_dict_from_jax``'s name map and
    layout, as the parameters do (a kernel's transpose applies to its
    moments alike)."""
    opt = payload["opt_state"]
    inner = opt["inner_state"]["0"]
    stats = payload.get("batch_stats", {})
    mu = state_dict_from_jax({"params": inner["mu"], "batch_stats": stats})
    nu = state_dict_from_jax({"params": inner["nu"], "batch_stats": stats})
    count = float(np.asarray(inner["count"]))
    hp = opt["hyperparams"]
    if float(np.asarray(hp.get("eps_root", 0.0))) != 0.0:
        raise ValueError("usip_tpu Adam with eps_root != 0 has no "
                         "torch.optim.Adam counterpart")
    optimizer = state.optimizer
    optimizer.state.clear()
    for name, p in state.model.named_parameters():
        if name not in mu:
            raise ValueError(f"usip_tpu Adam state has no moments for {name}")
        optimizer.state[p] = {
            "step": torch.tensor(count, dtype=torch.float32),
            "exp_avg": mu[name].to(p.device, p.dtype).reshape(p.shape),
            "exp_avg_sq": nu[name].to(p.device, p.dtype).reshape(p.shape)}
    for group in optimizer.param_groups:
        group.update(lr=float(np.asarray(hp["learning_rate"])),
                     betas=(float(np.asarray(hp["b1"])),
                            float(np.asarray(hp["b2"]))),
                     eps=float(np.asarray(hp["eps"])))


def save_checkpoint(path: str, state, metadata: Optional[Dict] = None) -> None:
    """Write ``state`` (a ``TrainState``) to ``path`` atomically, and the
    metadata to ``path + '.json'``. Under ``torch.distributed`` every rank
    calls it, rank 0 alone writes (the replicas are identical), and a
    barrier follows, so that no rank reads the file before it is whole."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        if dist.get_rank() == 0:
            _write_checkpoint(path, state, metadata)
        dist.barrier()
        return
    _write_checkpoint(path, state, metadata)


def _write_checkpoint(path: str, state, metadata: Optional[Dict]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {"step": int(state.step), "model": state.model.state_dict(),
               "optimizer": state.optimizer.state_dict()}
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    if metadata is not None:
        with open(path + ".json", "w") as f:
            json.dump(metadata, f, indent=2, default=str)


def _load_model(model: torch.nn.Module, sd: Dict[str, torch.Tensor],
                path: str) -> None:
    own = model.state_dict()
    for k, v in sd.items():
        if k in own and tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(
                f"checkpoint {path!r} holds {k} of shape {tuple(v.shape)}, "
                f"the model expects {tuple(own[k].shape)}: it was trained "
                "with other widths (e.g. a full-width detector where the "
                "lite widths are built: retrain with --lite, or override "
                "detector.c1/c2 to match)")
    model.load_state_dict(sd, strict=True)


def restore_checkpoint(path: str, state) -> Optional[Dict]:
    """Restore ``state`` in place from ``path`` and return the sidecar's
    metadata (None without one). A ``.msgpack`` path is read as a usip_tpu
    checkpoint: parameters, BatchNorm statistics, step and Adam state (the
    moments, their count and the injected hyperparameters)."""
    if path.endswith(".msgpack"):
        payload = read_msgpack(path)
        _load_model(state.model, _model_state(payload), path)
        if "opt_state" in payload:
            _load_adam(state, payload)
        state.step = int(np.asarray(payload.get("step", 0)))
    else:
        dev = next(state.model.parameters()).device
        payload = torch.load(path, map_location=dev, weights_only=True)
        if not (isinstance(payload, dict) and all(
                k in payload for k in ("step", "model", "optimizer"))):
            raise ValueError(
                f"{path!r} is not a full-state checkpoint (step, model, "
                "optimizer): a bare state_dict, such as a reference .pth, "
                "seeds a run after `python -m usip_tpu_torch.cli "
                "import-torch --pth FILE --out FILE.pt`")
        _load_model(state.model, payload["model"], path)
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
    meta = None
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return meta


def save_params_only(path: str, model: torch.nn.Module) -> None:
    """Inference-only export (the reference's ``{epoch}_net_detector.pth``
    analog): the model's ``state_dict`` (parameters and BatchNorm
    statistics), written atomically; rank 0 alone under
    ``torch.distributed``."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() and dist.get_rank():
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(model.state_dict(), tmp)
    os.replace(tmp, path)


def load_params_only(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a params-only file into ``model``: the port's ``.pt`` (a
    ``state_dict``) or usip_tpu's ``save_params_only`` ``.msgpack`` (its
    ``params`` tree alone: the model's BatchNorm statistics are kept)."""
    if path.endswith(".msgpack"):
        params = read_msgpack(path)
        own = model.state_dict()
        stats = _stats_template(params)
        sd = state_dict_from_jax({"params": params, "batch_stats": stats})
        sd = {k: (own[k] if k.endswith(("running_mean", "running_var",
                                        "num_batches_tracked")) else v)
              for k, v in sd.items()}
    else:
        dev = next(model.parameters()).device
        sd = torch.load(path, map_location=dev, weights_only=True)
    _load_model(model, sd, path)
    return model


def _stats_template(params: Dict[str, Any]) -> Dict[str, Any]:
    """A ``batch_stats`` tree shaped like ``params``' norms (values unused:
    a params-only file keeps the model's own statistics)."""
    out = {}
    for k, v in params.items():
        if not isinstance(v, dict):
            continue
        if k == "norm":
            out[k] = {"mean": v["scale"], "var": v["scale"]}
        else:
            sub = _stats_template(v)
            if sub:
                out[k] = sub
    return out


def find_checkpoint(out_dir: str) -> Optional[str]:
    """``<out_dir>/best.pt``, else ``last.pt``, else None."""
    for name in ("best", "last"):
        path = os.path.join(out_dir, f"{name}.pt")
        if os.path.exists(path):
            return path
    return None
