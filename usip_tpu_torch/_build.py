"""Build the CUDA kernels of ``csrc/`` with nvcc, and the host data-path
library of ``csrc/host/`` with g++, and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
into ``build/usip_tpu_torch/<name>-<hash>.so`` beside the package, at first
use; ``csrc/host/usip_native.cpp`` (the batch loader, ``native.py``) into
``build/usip_tpu_torch/usip_native-<hash>.so`` with ``native/Makefile``'s
flags. The hash covers the source and the flags, so an edited source builds
anew and an unchanged one is loaded as it is. Every build compiles to a
private name and renames it into place, so processes that build the same
library at once never load a half-written one. A failed build raises with
the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

KERNELS = ("fps", "min_argmin", "fusion_chain", "smallest_k", "scatter_max",
           "batch_norm")
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "usip_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC")
HOST_SRC = CSRC / "host" / "usip_native.cpp"
# native/Makefile's CXXFLAGS and LDFLAGS (-march=native: F16C's fp16 encode)
GXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared",
             "-pthread")


def nvcc_path() -> str:
    """The nvcc on PATH, else the one of ``$CUDA_HOME`` or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (looked on PATH, in $CUDA_HOME/bin and "
                       "/usr/local/cuda/bin): the usip_tpu_torch CUDA kernels "
                       "are built with the CUDA toolkit's nvcc")


def _hashed(stem: str, src: Path, flags, build_dir: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(flags).encode()).hexdigest()
    return Path(build_dir) / f"{stem}-{digest[:16]}.so"


def library_path(name: str, build_dir: Path = BUILD_DIR) -> Path:
    return _hashed(name, CSRC / f"{name}.cu", NVCC_FLAGS, build_dir)


def _compile(argv, src: Path, out: Path, what: str) -> Path:
    """Run ``argv + ['-o', <private name>, src]`` and rename the result to
    ``out``: a process that builds the same library at the same time never
    loads a half-written one."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run([*argv, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{what} failed to build {src.name} "
                               f"(exit {proc.returncode}):\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def build(name: str, build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    if name not in KERNELS:
        raise ValueError(f"unknown kernel {name!r}; choose from {KERNELS}")
    out = library_path(name, build_dir)
    if out.exists():
        return out
    return _compile([nvcc_path(), *NVCC_FLAGS], CSRC / f"{name}.cu", out,
                    "nvcc")


def host_library_path(build_dir: Path = BUILD_DIR,
                      flags=GXX_FLAGS) -> Path:
    return _hashed("usip_native", HOST_SRC, flags, build_dir)


def build_host(build_dir: Path = BUILD_DIR, flags=GXX_FLAGS) -> Path:
    """Compile ``csrc/host/usip_native.cpp`` with g++ unless its library is
    already built; raises with g++'s output when it cannot."""
    out = host_library_path(build_dir, flags)
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the usip_tpu_torch host "
                           "data-path library is built with g++")
    return _compile([gxx, *flags], HOST_SRC, out, "g++")


def build_all(build_dir: Path = BUILD_DIR) -> None:
    """Compile every kernel, one nvcc process each, and the host library,
    side by side."""
    with ThreadPoolExecutor(len(KERNELS) + 1) as pool:
        futures = [pool.submit(build, n, build_dir) for n in KERNELS]
        futures.append(pool.submit(build_host, build_dir))
        for future in futures:
            future.result()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first where needed."""
    return ctypes.CDLL(str(build(name)))
