"""Build and load the hand-written CUDA kernels and the host libraries.

Each ``.cu`` source under ``keystone_tpu_torch/csrc/`` is compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library with a plain C
interface, loaded with `ctypes`. Nothing here runs at import: the first
launch of a kernel builds it, into ``keystone_tpu_torch/_build/``
(git-ignored), under a name keyed by a hash of the source and the flags,
so an edited source is rebuilt and an unchanged one is reused. `build`
compiles several sources at once, one ``nvcc`` process each.

The host route (`build_host`, `load_host`) builds the image loaders'
C++ sources the same way with ``$CXX`` (default ``c++``): the tar index
(`keystone_io.cpp`) and the port's own baseline JPEG decoder
(`jpeg_baseline.cpp`). Neither links a library: the card's machine has
no libjpeg.

Each build is a cold compile and each load of a library built earlier a
cache hit, for the telemetry's compile accounting
(`telemetry/compile_events.py`).
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
from typing import Dict, Iterable, Optional, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

#: kernel library name -> its source under csrc/
SOURCES = {
    "conv_rectify_pool": "conv_rectify_pool.cu",
    "rectify_pool": "rectify_pool.cu",
    "elementwise_chain": "elementwise_chain.cu",
    "rbf_block": "rbf_block.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: host library name -> (its C++ source under csrc/, libraries it links)
HOST_SOURCES = {
    "keystone_io": ("keystone_io.cpp", ()),
    "keystone_jpegdec": ("jpeg_baseline.cpp", ()),
}

HOST_FLAGS = ("-O3", "-fPIC", "-shared", "-pthread", "-std=c++17")

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


def _recipe(name: str) -> Tuple[Path, Tuple[str, ...], Tuple[str, ...]]:
    """``(source, flags, libraries)`` of a CUDA or host library."""
    if name in HOST_SOURCES:
        source, libs = HOST_SOURCES[name]
        return CSRC_DIR / source, HOST_FLAGS, libs
    return CSRC_DIR / SOURCES[name], NVCC_FLAGS, ()


def _compiler(name: str) -> str:
    if name in HOST_SOURCES:
        return os.environ.get("CXX") or "c++"
    return nvcc_path()


def library_path(name: str) -> Path:
    src, flags, libs = _recipe(name)
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join(flags + libs).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _compile(names: Iterable[str], kind: str) -> Dict[str, float]:
    """Compile the named libraries that are not built yet, one compiler
    process each, all at once; each build lands under its hashed name by
    an atomic rename, so concurrent builders of one library (test
    workers) each leave a whole library. Returns the seconds each build
    took (0 for a library already built); the compiler's output goes to
    ``<library>.log``. Raises RuntimeError with that output when a build
    fails."""
    from ..telemetry.compile_events import record_compile

    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    seconds = {name: 0.0 for name in names}
    running = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        src, flags, libs = _recipe(name)
        tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        log = open(lib.with_suffix(f".{os.getpid()}.log"), "w")
        cmd = [_compiler(name), *flags, "-o", str(tmp), str(src), *libs]
        running[name] = (subprocess.Popen(cmd, stdout=log,
                                          stderr=subprocess.STDOUT),
                         log, tmp, lib, time.perf_counter(), cmd[0])
    failed = []
    for name, (proc, log, tmp, lib, t0, compiler) in running.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        text = Path(log.name).read_text()
        if rc == 0:
            os.replace(log.name, lib.with_suffix(".log"))
            os.replace(tmp, lib)
            record_compile(name, seconds[name], cold=True, kind=kind)
        else:
            os.unlink(log.name)
            failed.append(
                f"{name}: {os.path.basename(compiler)} exited {rc}\n{text}")
    if failed:
        raise RuntimeError(f"{kind} build failed:\n" + "\n".join(failed))
    return seconds


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named CUDA libraries (default: all) that are not
    built yet, all ``nvcc`` processes at once (`_compile`); the register
    and shared-memory report lands in ``<library>.log``."""
    return _compile(list(SOURCES) if names is None else names, "kernel")


def build_host(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named host libraries (default: all) that are not
    built yet (`_compile`)."""
    return _compile(list(HOST_SOURCES) if names is None else names, "host")


def build_log(name: str) -> str:
    """The compiler's output for the current build of ``name``."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _load(name: str, builder) -> ctypes.CDLL:
    """The loaded library ``name``, built by ``builder`` first if
    needed; loading one built earlier counts as a compile cache hit."""
    from ..telemetry.compile_events import record_compile

    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            built = builder([name])[name] > 0
            t0 = time.perf_counter()
            lib = ctypes.CDLL(str(library_path(name)))
            if not built:
                record_compile(name, time.perf_counter() - t0, cold=False,
                               kind="host" if name in HOST_SOURCES
                               else "kernel")
            _loaded[name] = lib
        return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded CUDA library ``name``, built first if needed."""
    lib = _load(name, build)
    lib.keystone_error_string.argtypes = [ctypes.c_int]
    lib.keystone_error_string.restype = ctypes.c_char_p
    return lib


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library ``name``, built first if needed."""
    return _load(name, build_host)
