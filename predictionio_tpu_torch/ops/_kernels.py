"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles with
``nvcc`` for ``sm_90a`` into ``<build dir>/lib<name>.so``, loaded with
``ctypes``. The build runs on first use (never on import) and again
whenever the source is newer than the library. The build directory is
``PIO_TORCH_KERNEL_DIR``, or ``predictionio_tpu_torch/_build`` inside
the checkout (listed in ``.gitignore``).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: ptxas register / shared-memory report of each build this process ran
build_logs: Dict[str, str] = {}


def build_dir() -> Path:
    return Path(os.environ.get("PIO_TORCH_KERNEL_DIR") or (_PKG / "_build"))


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    return build_dir() / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = library_path(name)
    src = CSRC / f"{name}.cu"
    return not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime


def build(*names: str) -> Dict[str, float]:
    """Compile ``csrc/<name>.cu`` for each name, all nvcc processes
    started together; returns the seconds each took. Raises on a failure,
    with the compiler's output."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        tmp = out / f"lib{name}.{os.getpid()}.so"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (cmd, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    took = {}
    failed = []
    for name, (cmd, tmp, t0, proc) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{log}")
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib: Optional[ctypes.CDLL] = _libs.get(name)
        if lib is None:
            if _stale(name):
                build(name)
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib
