"""ctypes bindings of the port's host data-path library (counterpart of
``usip_tpu/native.py``): ``csrc/host/usip_native.cpp``, the port's own copy
of usip_tpu's ``native/usip_native.cpp`` with the same C ABI and draws.

``_build.build_host`` compiles it with g++ at first use into
``build/usip_tpu_torch/usip_native-<hash>.so``; nothing here reads usip_tpu's
``native/`` directory. Every entry point has usip_tpu's numpy fallback, so
the port runs without a compiler; the library is the default for the host
loader work (``data/loaders.py get_batch``). Which path this process took,
and why, is logged once, at the first call (``utils/logging.py notice``).
To force the numpy path, make ``available`` return False (a test:
``monkeypatch.setattr(usip_tpu_torch.native, "available", lambda: False)``).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

from usip_tpu_torch.utils.logging import notice

_lib = None
_path: Optional[str] = None
_load_failed = False
# the loader's prefetch thread and the caller may both make the first call
_load_lock = threading.Lock()


def _get_lib() -> Optional[ctypes.CDLL]:
    with _load_lock:
        return _load()


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _path, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    from usip_tpu_torch import _build
    try:
        path = str(_build.build_host())
        lib = ctypes.CDLL(path)
    except (RuntimeError, OSError) as e:
        _load_failed = True
        notice("[native] host library unavailable, the host loader takes "
               f"its numpy path: {str(e).strip()[:2000]}")
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    lib.usip_subsample.argtypes = [f32p, ctypes.c_int64, ctypes.c_int64,
                                   ctypes.c_int64, ctypes.c_uint64, f32p]
    lib.usip_fps.argtypes = [f32p, ctypes.c_int64, ctypes.c_int64,
                             ctypes.c_uint64, f32p, i64p]
    lib.usip_nms.argtypes = [f32p, f32p, ctypes.c_int64, ctypes.c_float,
                             f32p, f32p]
    lib.usip_nms.restype = ctypes.c_int64
    lib.usip_npy_probe.argtypes = [ctypes.c_char_p, i64p, i64p]
    lib.usip_npy_probe.restype = ctypes.c_int
    lib.usip_npy_read_f32.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int64]
    lib.usip_npy_read_f32.restype = ctypes.c_int
    for name, out_p in (("usip_batch_load_subsample", f32p),
                        ("usip_batch_load_subsample_f16", u16p)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64,
                       ctypes.c_int, out_p, out_p]
        fn.restype = ctypes.c_int
    _lib, _path = lib, path
    notice(f"[native] host library {path}: batches are assembled in its "
           "C++ thread pool")
    return _lib


def available() -> bool:
    return _get_lib() is not None


def library_path() -> Optional[str]:
    """The loaded library's file, or None when the numpy path is taken."""
    _get_lib()
    return _path


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def subsample(data: np.ndarray, target: int, seed: int = 0) -> np.ndarray:
    """Native fixed-size random subsample (pad-by-repetition when short)."""
    lib = _get_lib()
    data = np.ascontiguousarray(data, np.float32)
    n, c = data.shape
    if lib is None:
        from usip_tpu_torch.data.common import subsample_fixed
        return subsample_fixed(np.random.default_rng(seed), data, target)
    out = np.empty((target, c), np.float32)
    lib.usip_subsample(_fptr(data), n, c, target, seed, _fptr(out))
    return out


def fps(points: np.ndarray, k: int, seed: int = 0
        ) -> Tuple[np.ndarray, np.ndarray]:
    """Native farthest point sampling -> (samples (k,3), indices (k,))."""
    lib = _get_lib()
    points = np.ascontiguousarray(points[:, :3], np.float32)
    n = points.shape[0]
    if lib is None:
        rng = np.random.default_rng(seed)
        first = int(rng.integers(0, n))
        idxs = [first]
        d = ((points - points[first]) ** 2).sum(1)
        for _ in range(1, k):
            far = int(np.argmax(d))
            idxs.append(far)
            d = np.minimum(d, ((points - points[far]) ** 2).sum(1))
        return points[idxs], np.asarray(idxs, np.int64)
    out = np.empty((k, 3), np.float32)
    idx = np.empty((k,), np.int64)
    lib.usip_fps(_fptr(points), n, k, seed, _fptr(out),
                 idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out, idx


def nms(keypoints: np.ndarray, sigmas: np.ndarray, radius: float
        ) -> Tuple[np.ndarray, np.ndarray]:
    """Native greedy sigma-ascending NMS; falls back to eval.export.nms."""
    lib = _get_lib()
    if radius < 0.01:
        return keypoints, sigmas
    if lib is None:
        from usip_tpu_torch.eval.export import nms as py_nms
        return py_nms(keypoints, sigmas, radius)
    kp = np.ascontiguousarray(keypoints, np.float32)
    sg = np.ascontiguousarray(sigmas, np.float32)
    m = kp.shape[0]
    out_kp = np.empty_like(kp)
    out_sig = np.empty_like(sg)
    kept = lib.usip_nms(_fptr(kp), _fptr(sg), m, radius, _fptr(out_kp),
                        _fptr(out_sig))
    return out_kp[:kept], out_sig[:kept]


def read_npy(path: str) -> np.ndarray:
    """Native .npy reader (f4/f8 2-D C-order)."""
    lib = _get_lib()
    if lib is None:
        return np.load(path).astype(np.float32)
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    rc = lib.usip_npy_probe(path.encode(), ctypes.byref(rows),
                            ctypes.byref(cols))
    if rc != 0:
        raise IOError(f"usip_npy_probe({path}) failed: {rc}")
    out = np.empty((rows.value, cols.value), np.float32)
    rc = lib.usip_npy_read_f32(path.encode(), _fptr(out), out.size)
    if rc != 0:
        raise IOError(f"usip_npy_read_f32({path}) failed: {rc}")
    return out


def batch_load_subsample(paths, target: int, sn_len: int, seed: int = 0,
                         threads: int = 0, dtype=np.float32
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Thread-pooled load+subsample+split of a batch of .npy clouds.

    Returns (pc (B, target, 3), sn (B, target, sn_len)). Item ``b`` draws
    from the seed ``seed + b * 7919``, so the batch is the same for any
    ``threads`` (0: one a core).

    ``dtype=np.float16`` encodes the fp16 wire in the C++ thread pool
    (F16C round-to-nearest-even, identical to numpy ``astype(float16)``) so
    the Python prefetch thread does no conversion pass at all.
    """
    lib = _get_lib()
    b = len(paths)
    dtype = np.dtype(dtype)
    if dtype not in (np.float32, np.float16):
        raise ValueError(f"batch_load_subsample: dtype must be float32 or "
                         f"float16, got {dtype}")
    if lib is None:
        from usip_tpu_torch.data.common import split_pc_sn, subsample_fixed
        rng = np.random.default_rng(seed)
        pcs, sns = [], []
        for p in paths:
            data = subsample_fixed(rng, np.load(p), target)
            pc, sn = split_pc_sn(data, sn_len)
            pcs.append(pc)
            sns.append(sn)
        return (np.stack(pcs).astype(dtype, copy=False),
                np.stack(sns).astype(dtype, copy=False))
    out_pc = np.empty((b, target, 3), dtype)
    out_sn = np.empty((b, target, max(sn_len, 1)), dtype)
    arr = (ctypes.c_char_p * b)(*[p.encode() for p in paths])
    if dtype == np.float16:
        u16p = ctypes.POINTER(ctypes.c_uint16)
        rc = lib.usip_batch_load_subsample_f16(
            arr, b, target, sn_len, seed, threads,
            out_pc.ctypes.data_as(u16p), out_sn.ctypes.data_as(u16p))
    else:
        rc = lib.usip_batch_load_subsample(arr, b, target, sn_len, seed,
                                           threads, _fptr(out_pc),
                                           _fptr(out_sn))
    if rc != 0:
        detail = {10: "npy probe failed", 11: "npy read failed",
                  12: f"cloud has fewer than {3 + sn_len} columns "
                      f"(need 3 coords + {sn_len} normals)"}.get(rc, "")
        raise IOError(f"usip_batch_load_subsample failed: {rc} {detail}")
    return out_pc, out_sn[:, :, :sn_len]
