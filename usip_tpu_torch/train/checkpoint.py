"""Checkpoints of the port (counterpart of ``usip_tpu/train/checkpoint.py``).

The port's own format is a ``torch.save`` file (``.pt``) holding ``{"step",
"model", "optimizer"}``: the model's ``state_dict`` (parameters and
BatchNorm buffers, under the reference's names) and the Adam state, written
atomically through a ``.tmp`` rename, with a JSON sidecar (``<path>.json``)
holding the metadata ``DetectorEngine.resume`` reads (``epoch``, ``loss``,
``fit_samples``).

usip_tpu's checkpoints (``.msgpack``: flax ``serialization.to_bytes`` of
``{"step", "params", "batch_stats", "opt_state"}``) are read without flax or
msgpack by ``read_msgpack``, a decoder of the subset of msgpack that flax
writes. Their parameters and BatchNorm statistics load through
``weights.state_dict_from_jax``; their Adam moments are not carried over
(optax's and torch's Adam states differ in layout), so the optimizer starts
fresh from such a file.
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
    """The detector ``state_dict`` and step count of a usip_tpu checkpoint."""
    payload = read_msgpack(path)
    sd = state_dict_from_jax({"params": payload["params"],
                              "batch_stats": payload.get("batch_stats", {})})
    return sd, int(np.asarray(payload.get("step", 0)))


def save_checkpoint(path: str, state, metadata: Optional[Dict] = None) -> None:
    """Write ``state`` (a ``TrainState``) to ``path`` atomically, and the
    metadata to ``path + '.json'``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {"step": int(state.step), "model": state.model.state_dict(),
               "optimizer": state.optimizer.state_dict()}
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    if metadata is not None:
        with open(path + ".json", "w") as f:
            json.dump(metadata, f, indent=2, default=str)


def _load_model(state, sd: Dict[str, torch.Tensor], path: str) -> None:
    own = state.model.state_dict()
    for k, v in sd.items():
        if k in own and tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(
                f"checkpoint {path!r} holds {k} of shape {tuple(v.shape)}, "
                f"the model expects {tuple(own[k].shape)}: it was trained "
                "with other widths (e.g. a full-width detector where the "
                "lite widths are built: retrain with --lite, or override "
                "detector.c1/c2 to match)")
    state.model.load_state_dict(sd, strict=True)


def restore_checkpoint(path: str, state) -> Optional[Dict]:
    """Restore ``state`` in place from ``path`` and return the sidecar's
    metadata (None without one). A ``.msgpack`` path is read as a usip_tpu
    checkpoint: parameters, BatchNorm statistics and step; the optimizer
    keeps its fresh state."""
    if path.endswith(".msgpack"):
        sd, step = state_dict_from_msgpack(path)
        _load_model(state, sd, path)
        state.step = step
    else:
        dev = next(state.model.parameters()).device
        payload = torch.load(path, map_location=dev, weights_only=True)
        _load_model(state, payload["model"], path)
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
    meta = None
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return meta


def find_checkpoint(out_dir: str) -> Optional[str]:
    """``<out_dir>/best.pt``, else ``last.pt``, else None."""
    for name in ("best", "last"):
        path = os.path.join(out_dir, f"{name}.pt")
        if os.path.exists(path):
            return path
    return None
