"""ctypes bindings for the image loaders' native code: the tar index and
the JPEG decoder.

Counterpart of `keystone_tpu/utils/native_io.py:134-214` (`tar_index`,
`decode_jpeg_batch`), over the port's own sources, built at first use by
`ops/_build.py`: `csrc/keystone_io.cpp` (the tar index) and
`csrc/jpeg_baseline.cpp` (the port's own baseline decoder, equal to
libjpeg's output bit for bit). Neither links anything but the C++
runtime: the card's machine has no libjpeg, and nvJPEG's IDCT and chroma
upsampling round differently from libjpeg's. A library that cannot be
built raises; there is no other route. ctypes releases the interpreter
lock for the calls, so the decoder's threads run in parallel.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops import _build

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_PI32 = ctypes.POINTER(ctypes.c_int32)

_NAME_CAP = 512

_lock = threading.Lock()
_typed: set = set()


def _lib(name: str) -> ctypes.CDLL:
    """The library ``name`` loaded with its functions' types declared."""
    lib = _build.load_host(name)
    with _lock:
        if name in _typed:
            return lib
        if name == "keystone_io":
            lib.ks_tar_index.restype = _I64
            lib.ks_tar_index.argtypes = [_P, _I64, _P, _P, _P, _I64, _I64]
        else:
            lib.ks_jpegdec_dims.restype = ctypes.c_int
            lib.ks_jpegdec_dims.argtypes = [_P, _I64, _PI32, _PI32]
            lib.ks_jpegdec_decode_batch.restype = _I64
            lib.ks_jpegdec_decode_batch.argtypes = [
                _P, _P, _P, _I64, _P, _P, _P, _P, _P, ctypes.c_int]
        _typed.add(name)
    return lib


def decode_threads() -> int:
    """Threads the host decoder runs: one a core."""
    return max(os.cpu_count() or 1, 1)


def _as_array(buf) -> np.ndarray:
    """A uint8 view of ``buf`` (bytes, an mmap, an array), no copy."""
    return np.frombuffer(buf, np.uint8)


def tar_index(buf) -> Optional[List[Tuple[str, int, int]]]:
    """``[(name, offset, size)]`` of the regular files of a tar archive
    held in ``buf`` (ustar, pax and GNU long names); offsets point into
    ``buf``, so entries slice without a copy. None for a malformed
    archive."""
    lib = _lib("keystone_io")
    arr = _as_array(buf)
    cap = 1024
    while True:
        offsets = np.empty(cap, np.int64)
        sizes = np.empty(cap, np.int64)
        names = np.zeros((cap, _NAME_CAP), np.uint8)
        n = lib.ks_tar_index(arr.ctypes.data, arr.size, offsets.ctypes.data,
                             sizes.ctypes.data, names.ctypes.data, _NAME_CAP,
                             cap)
        if n < 0:
            return None
        if n <= cap:
            break
        cap = int(n)
    return [(names[i].tobytes().split(b"\0", 1)[0].decode(
        "utf-8", errors="replace"), int(offsets[i]), int(sizes[i]))
        for i in range(int(n))]


def decode_jpeg_batch(buf, entries: Sequence[Tuple[int, int]],
                      device: DeviceLike = "cpu",
                      num_threads: Optional[int] = None):
    """Decode the JPEGs at ``entries`` (``(offset, size)`` into ``buf``)
    as float32 (H, W, 3) RGB tensors on ``device``: ``(images, ok)``,
    ``images[i]`` None where entry i did not decode, ``ok`` the count
    that did (`keystone_tpu/utils/native_io.py:172-214`).

    `csrc/jpeg_baseline.cpp` decodes on ``num_threads`` host threads
    (default one a core) into one uint8 buffer, which goes to ``device``
    in one copy and becomes float32 there; each image is a view of the
    result. An entry that is corrupt, or in a form the decoder does not
    read (progressive, arithmetic-coded, 12-bit, CMYK), is None: the
    loaders skip it, as the JAX package's native route skips the
    entries its libjpeg does not decode."""
    device = resolve_device(device)
    lib = _lib("keystone_jpegdec")
    arr = _as_array(buf)
    n = len(entries)
    if n == 0:
        return [], 0
    offsets = np.array([e[0] for e in entries], np.int64)
    sizes = np.array([e[1] for e in entries], np.int64)
    caps = np.zeros(n, np.int64)
    h, w = ctypes.c_int32(), ctypes.c_int32()
    for i in range(n):
        rc = lib.ks_jpegdec_dims(arr.ctypes.data + int(offsets[i]),
                                 int(sizes[i]), ctypes.byref(h),
                                 ctypes.byref(w))
        if rc == 0:
            caps[i] = h.value * w.value * 3
    out_offsets = np.zeros(n, np.int64)
    np.cumsum(caps[:-1], out=out_offsets[1:])
    host = torch.empty(max(int(caps.sum()), 1), dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    dims = np.zeros((n, 3), np.int32)
    status = np.full(n, 1, np.int32)
    ok = lib.ks_jpegdec_decode_batch(
        arr.ctypes.data, offsets.ctypes.data, sizes.ctypes.data, n,
        host.data_ptr(), out_offsets.ctypes.data, caps.ctypes.data,
        dims.ctypes.data, status.ctypes.data, num_threads or decode_threads())
    flat = host.to(device, non_blocking=True).to(torch.float32)
    images = []
    for i in range(n):
        if status[i] == 0:
            hh, ww = int(dims[i, 0]), int(dims[i, 1])
            start = int(out_offsets[i])
            images.append(flat[start:start + hh * ww * 3].view(hh, ww, 3))
        else:
            images.append(None)
    return images, int(ok)
