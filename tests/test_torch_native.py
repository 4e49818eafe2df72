"""The port's host data-path library (``usip_tpu_torch.native``, built by g++
from ``usip_tpu_torch/csrc/host/usip_native.cpp``) against usip_tpu's
(``usip_tpu.native``, its own ``native/`` build), on the CPU.

Each entry point of both packages gets the same numpy inputs and seeds and
must give the same arrays (``np.array_equal``, dtypes included): the
subsample with n >= target and n < target, FPS, NMS, the ``.npy`` reader
(f4 and f8, header versions 1 and 2), the thread-pooled batch loader in
fp32 and fp16 at sn_len 0, 1, 3 and 5 with seeds above 2**63, its
rejection of short rows, its thread-count invariance; then each numpy
fallback with both packages' libraries switched off. The fp16 encode is
held against numpy's ``astype(float16)`` at half-ulp ties, subnormals and
overflow, both with F16C (the default ``-march=native`` build) and without
it (a build with ``-mno-f16c``, the bit-twiddled fallback).
"""

import ctypes
import os

import numpy as np
import pytest

import usip_tpu.native as jax_native
from usip_tpu_torch import _build
from usip_tpu_torch import native

pytestmark = pytest.mark.skipif(
    not (native.available() and jax_native.available()),
    reason="both host libraries must build (g++) for the comparison")

SEEDS = (0, 7, 2 ** 62 + 12345, 2 ** 64 - 1)


def _clouds(root, rows=(300, 350, 420, 64, 1000), cols=8, seed=0,
            dtype=np.float32):
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i, n in enumerate(rows):
        p = str(root / f"{i}.npy")
        np.save(p, rng.normal(0, 10, size=(n, cols)).astype(dtype))
        paths.append(p)
    return paths


def _equal(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b, equal_nan=True)


@pytest.fixture
def both_off(monkeypatch):
    """Both packages on their numpy paths."""
    monkeypatch.setattr(jax_native, "_get_lib", lambda: None)
    monkeypatch.setattr(native, "_get_lib", lambda: None)


def test_the_port_loads_its_own_build(tmp_path):
    """The loaded library is the port's build under ``build/``; a build
    that fails raises with g++'s output and leaves no library behind."""
    path = native.library_path()
    assert path.startswith(str(_build.BUILD_DIR) + os.sep)
    assert os.path.basename(path).startswith("usip_native-")
    assert os.path.realpath(path) != os.path.realpath(jax_native._SO_PATH)
    bad = _build.GXX_FLAGS + ("-fno-such-option-anywhere",)
    with pytest.raises(RuntimeError,
                       match="(?s)g\\+\\+ failed.*no-such-option"):
        _build.build_host(tmp_path, flags=bad)
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("n", [50, 257, 1000])
def test_subsample_equals_usip_tpu(n):
    """n < target (repetition, remainder and shuffle), n == target-ish and
    n > target (partial Fisher-Yates)."""
    data = np.random.default_rng(1).normal(size=(n, 7)).astype(np.float32)
    for seed in SEEDS:
        _equal(native.subsample(data, 256, seed=seed),
               jax_native.subsample(data, 256, seed=seed))


def test_fps_and_nms_equal_usip_tpu():
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(2000, 5)).astype(np.float32)
    pts[100:110] = pts[0]  # duplicates: first-occurrence farthest
    for seed in SEEDS:
        _equal(native.fps(pts, 64, seed=seed), jax_native.fps(pts, 64,
                                                              seed=seed))
    kp = rng.normal(size=(300, 3)).astype(np.float32)
    sig = rng.uniform(0.1, 1.0, 300).astype(np.float32)
    for radius in (0.005, 0.3, 1.5):
        _equal(native.nms(kp, sig, radius), jax_native.nms(kp, sig, radius))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("version", [(1, 0), (2, 0)])
def test_read_npy_equals_usip_tpu(tmp_path, dtype, version):
    arr = np.random.default_rng(3).normal(size=(123, 6)).astype(dtype)
    path = str(tmp_path / "a.npy")
    with open(path, "wb") as f:
        np.lib.format.write_array(f, arr, version=version)
    with open(path, "rb") as f:
        assert np.lib.format.read_magic(f) == version
    _equal(native.read_npy(path), jax_native.read_npy(path))
    _equal(native.read_npy(path), arr.astype(np.float32))
    with pytest.raises(IOError):
        native.read_npy(str(tmp_path / "missing.npy"))


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
@pytest.mark.parametrize("sn_len", [0, 1, 3, 5])
def test_batch_load_subsample_equals_usip_tpu(tmp_path, dtype, sn_len):
    """f32 and f16 wires, reflectance mode (sn_len 1 reads the last
    column), normals, none; clouds shorter and longer than the target; f8
    files; seeds past 2**63 (item b draws from seed + b * 7919 mod 2**64)."""
    paths = _clouds(tmp_path) + _clouds(tmp_path / "f8", rows=(333,), seed=4,
                                        dtype=np.float64)
    for seed in SEEDS:
        ours = native.batch_load_subsample(paths, 400, sn_len, seed=seed,
                                           dtype=dtype)
        ref = jax_native.batch_load_subsample(paths, 400, sn_len, seed=seed,
                                              dtype=dtype)
        _equal(ours, ref)
        assert ours[0].shape == (len(paths), 400, 3)
        assert ours[1].shape == (len(paths), 400, sn_len)


def test_batch_load_rows_and_thread_invariance(tmp_path):
    """Every output row is a row of its file (sn_len 5: columns 3..7), each
    row once where the file is long enough, repeated only where it is
    short; the batch is the same bytes at threads 0, 1, 2 and 5, and fp16
    is ``astype(float16)`` of fp32."""
    paths = _clouds(tmp_path)
    base = native.batch_load_subsample(paths, 400, 5, seed=11, threads=1)
    for threads in (0, 2, 5):
        _equal(native.batch_load_subsample(paths, 400, 5, seed=11,
                                           threads=threads), base)
    half = native.batch_load_subsample(paths, 400, 5, seed=11,
                                       dtype=np.float16)
    _equal(half, tuple(a.astype(np.float16) for a in base))
    for b, p in enumerate(paths):
        data = np.load(p)
        rows = np.concatenate([base[0][b], base[1][b]], axis=1)
        match = (rows[:, None, :] == data[None, :, :8]).all(-1)
        assert match.any(1).all(), p
        counts = match.sum(0)
        if len(data) >= 400:
            assert counts.max() == 1
        else:
            assert counts.min() == 400 // len(data)
            assert counts.max() == -(-400 // len(data))


def test_batch_load_rejects_short_rows(tmp_path):
    """A file with fewer columns than 3 + sn_len (4 in reflectance mode) is
    refused with usip_tpu's IOError, in both packages."""
    paths = _clouds(tmp_path, rows=(100, 100), cols=5)
    for sn_len in (1, 2):
        _equal(native.batch_load_subsample(paths, 64, sn_len),
               jax_native.batch_load_subsample(paths, 64, sn_len))
    for sn_len in (3, 4):
        msgs = []
        for mod in (native, jax_native):
            with pytest.raises(IOError) as e:
                mod.batch_load_subsample(paths, 64, sn_len)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1] and "12" in msgs[0]
    narrow = _clouds(tmp_path / "narrow", rows=(10,), cols=3, seed=5)
    with pytest.raises(IOError, match="12"):
        native.batch_load_subsample(narrow, 8, 1)
    with pytest.raises(IOError, match="10"):
        native.batch_load_subsample([str(tmp_path / "none.npy")], 8, 1)
    with pytest.raises(ValueError):
        native.batch_load_subsample(paths, 8, 1, dtype=np.float64)


def test_fallbacks_equal_usip_tpu(tmp_path, both_off):
    """Both libraries off: each entry point's numpy fallback."""
    assert not native.available() and not jax_native.available()
    paths = _clouds(tmp_path)
    for dtype in (np.float32, np.float16):
        for sn_len in (1, 4):
            _equal(native.batch_load_subsample(paths, 400, sn_len, seed=3,
                                               dtype=dtype),
                   jax_native.batch_load_subsample(paths, 400, sn_len,
                                                   seed=3, dtype=dtype))
    rng = np.random.default_rng(6)
    data = rng.normal(size=(90, 5)).astype(np.float32)
    for n in (64, 200):
        _equal(native.subsample(data, n, seed=4),
               jax_native.subsample(data, n, seed=4))
    _equal(native.fps(data, 16, seed=5), jax_native.fps(data, 16, seed=5))
    kp, sig = data[:, :3], np.abs(data[:, 3])
    _equal(native.nms(kp, sig, 0.5), jax_native.nms(kp, sig, 0.5))
    _equal(native.read_npy(paths[0]), jax_native.read_npy(paths[0]))


def _fp16_cases():
    """fp32 values at the fp16 encoder's hard cases: half-ulp ties (both
    parities), just off them, subnormals and their ties, the underflow
    boundary, 65504 and the overflow boundary (65520 ties up to inf),
    zeros, infinities and a NaN."""
    h = np.arange(0, 0x7C00, dtype=np.uint16)
    lo = h.view(np.float16).astype(np.float32)
    hi = (h + 1).view(np.float16).astype(np.float32)
    mid = (lo.astype(np.float64) + hi) / 2
    ties = mid.astype(np.float32)
    near = np.concatenate([np.nextafter(ties, np.float32(np.inf)),
                           np.nextafter(ties, np.float32(0))])
    special = np.array([0.0, -0.0, 2.0 ** -24, 2.0 ** -25, 2.0 ** -26,
                        1.5 * 2.0 ** -25, 65504.0, 65519.99, 65520.0, 7e4,
                        1e30, np.inf, -np.inf, np.nan], np.float32)
    vals = np.concatenate([lo, ties, near, special])
    return np.concatenate([vals, -vals]).astype(np.float32)


@pytest.mark.parametrize("f16c", [True, False])
def test_fp16_encode_equals_numpy(tmp_path, f16c):
    """The library's fp16 wire against ``astype(float16)`` bit for bit on
    ``_fp16_cases``, loaded as one cloud a call at target = rows (the
    subsample is then a permutation); the row index rides in the last column
    (reflectance mode, exact in fp16 below 2048) so the rows go back in file
    order."""
    vals = _fp16_cases()
    vals = np.concatenate([vals, np.zeros((-len(vals)) % 3, np.float32)])
    cloud = vals.reshape(-1, 3)
    n = len(cloud)
    path = str(tmp_path / "v.npy")
    flags = _build.GXX_FLAGS + (() if f16c else ("-mno-f16c",))
    lib = ctypes.CDLL(str(_build.build_host(flags=flags)))
    u16p = ctypes.POINTER(ctypes.c_uint16)
    f32p = ctypes.POINTER(ctypes.c_float)
    for fn, p in ((lib.usip_batch_load_subsample_f16, u16p),
                  (lib.usip_batch_load_subsample, f32p)):
        fn.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64,
                       ctypes.c_int, p, p]
        fn.restype = ctypes.c_int
    for start in range(0, n, 2048):
        chunk = cloud[start:start + 2048]
        m = len(chunk)
        data = np.concatenate([chunk, np.arange(m, dtype=np.float32)[:, None]],
                              axis=1)
        np.save(path, data)
        arr = (ctypes.c_char_p * 1)(path.encode())
        pc = np.empty((1, m, 3), np.float16)
        sn = np.empty((1, m, 1), np.float16)
        assert lib.usip_batch_load_subsample_f16(
            arr, 1, m, 1, 9, 1, pc.ctypes.data_as(u16p),
            sn.ctypes.data_as(u16p)) == 0
        order = np.argsort(sn[0, :, 0].astype(np.float32))
        got = pc[0][order].view(np.uint16)
        with np.errstate(over="ignore"):
            want = chunk.astype(np.float16).view(np.uint16)
        nan = np.isnan(chunk)
        assert np.array_equal(got[~nan], want[~nan])
        assert np.isnan(pc[0][order].astype(np.float32)[nan]).all()
