"""Build the CUDA kernels of ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
into ``build/usip_tpu_torch/<name>-<hash>.so`` beside the package, at first
use. The hash covers the source and the flags, so an edited source builds
anew and an unchanged one is loaded as it is. A failed build raises with
nvcc's output.
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

KERNELS = ("fps", "min_argmin", "fusion_chain", "smallest_k", "scatter_max")
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "usip_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC")


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


def library_path(name: str, build_dir: Path = BUILD_DIR) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return Path(build_dir) / f"{name}-{digest[:16]}.so"


def build(name: str, build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    if name not in KERNELS:
        raise ValueError(f"unknown kernel {name!r}; choose from {KERNELS}")
    out = library_path(name, build_dir)
    if out.exists():
        return out
    nvcc = nvcc_path()
    out.parent.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a process that builds the same
    # kernel at the same time never loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp,
                               str(CSRC / f"{name}.cu")],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {name}.cu "
                               f"(exit {proc.returncode}):\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def build_all(build_dir: Path = BUILD_DIR) -> None:
    """Compile every kernel, one nvcc process each, side by side."""
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        for future in [pool.submit(build, n, build_dir) for n in KERNELS]:
            future.result()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first where needed."""
    return ctypes.CDLL(str(build(name)))
