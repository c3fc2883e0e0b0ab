"""Build and load the hand-written CUDA kernels.

Each source under ``keystone_tpu_torch/csrc/`` is compiled by ``nvcc``
for Hopper (``sm_90a``) into a shared library with a plain C interface,
loaded with `ctypes`. Nothing here runs at import: the first launch of a
kernel builds it, into ``keystone_tpu_torch/_build/`` (git-ignored),
under a name keyed by a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is reused. `build` compiles
several sources at once, one ``nvcc`` process each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

#: kernel library name -> its source under csrc/
SOURCES = {
    "conv_rectify_pool": "conv_rectify_pool.cu",
    "rectify_pool": "rectify_pool.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    found = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
            "kernels are built from source at first use")
    return found


def library_path(name: str) -> Path:
    src = CSRC_DIR / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named kernel libraries that are not built yet, all
    ``nvcc`` processes at once. Returns the seconds each build took (0
    for a library already built). The compiler's output, register and
    shared-memory report included, goes to ``<library>.log``. Raises
    RuntimeError with that output when a build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    seconds = {name: 0.0 for name in names}
    running = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        log = open(lib.with_suffix(".log"), "w")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / SOURCES[name])]
        running[name] = (subprocess.Popen(cmd, stdout=log,
                                          stderr=subprocess.STDOUT),
                         log, tmp, lib, time.perf_counter())
    failed = []
    for name, (proc, log, tmp, lib, t0) in running.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        if rc == 0:
            os.replace(tmp, lib)
        else:
            failed.append(
                f"{name}: nvcc exited {rc}\n"
                + lib.with_suffix(".log").read_text())
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    """The compiler's output for the current build of ``name``."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            lib.keystone_error_string.argtypes = [ctypes.c_int]
            lib.keystone_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
        return lib
