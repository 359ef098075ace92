"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface
(``KERNELS``), compiled for Hopper (``sm_90a``) into a shared library under
``build/sdwebui_tpu_torch/`` at the repository root (override with
``SDTPU_TORCH_BUILD_DIR``).  The library's file name carries a hash of the
source, the shared headers and the flags, so an edit rebuilds it and an
unchanged source loads the existing build.  Nothing here runs at import
time: the first CUDA call of a kernel's wrapper triggers the build.
Different kernels build concurrently (one lock per kernel).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

#: the kernel sources of csrc/, one library each
KERNELS = ("flash_attention", "layer_norm", "conv3x3")

_locks = {name: threading.Lock() for name in KERNELS}
_libs: dict[str, ctypes.CDLL] = {}
#: seconds the last nvcc run took, per kernel (0.0 when loaded from a build)
build_seconds: dict[str, float] = {}


def build_dir() -> Path:
    env = os.environ.get("SDTPU_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "build" / "sdwebui_tpu_torch"


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of sdwebui_tpu_torch "
                           "are built from source at first use")
    return path


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((_CSRC / f"{name}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return h.hexdigest()[:16]


def load_library(name: str, rebuild: bool = False) -> ctypes.CDLL:
    """Return the loaded library for ``csrc/<name>.cu``, building it first
    when no build of the current sources exists (or when ``rebuild``)."""
    if name not in _locks:
        raise ValueError(f"unknown kernel {name!r}; one of {KERNELS}")
    with _locks[name]:
        if name in _libs and not rebuild:
            return _libs[name]
        out_dir = build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        lib_path = out_dir / f"lib{name}_{_digest(name)}.so"
        build_seconds[name] = 0.0
        if rebuild or not lib_path.exists():
            t0 = time.perf_counter()
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(_CSRC / f"{name}.cu")]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
            os.replace(tmp, lib_path)
            build_seconds[name] = time.perf_counter() - t0
        lib = ctypes.CDLL(str(lib_path))
        _libs[name] = lib
        return lib
