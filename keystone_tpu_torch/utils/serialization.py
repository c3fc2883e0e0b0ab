"""Saving and loading fitted pipelines with plain `pickle`.

Counterpart of `keystone_tpu/utils/serialization.py:37-60`
(`save_pytree_pickle`, `load_pytree_pickle`), which pickles with
cloudpickle and writes device arrays as host numpy. Here every tensor is
written as a CPU tensor (and every `torch.device` by name), and `load`
places them on the device asked for. Plain pickle carries no lambdas or
locally defined classes: `save` then raises TypeError naming the part
that cannot be pickled and writes nothing.

The multi-process format, counterpart of `save_pytree_orbax` and
`load_pytree_orbax` (`:56-193`), is a directory: the tensors are written
through `torch.distributed.checkpoint` (orbax has no torch side), the
rest is a pickle whose tensors are keys into that checkpoint, written by
rank 0 atomically with the format's tag, a fresh artifact id and the
tensors' keys, dtypes and shapes; the id is mirrored last into a sidecar
file. `save_pytree_dcp` and `load_pytree_dcp` are collective (every rank
of the group calls them) and end in a barrier. A load refuses loudly a
foreign or corrupt skeleton, a sidecar whose id is not the skeleton's
(a torn save) and a checkpoint whose tensors are not the skeleton's.
"""

from __future__ import annotations

import io
import os
import pickle
import uuid
from typing import Any, Dict, Iterable, List, Optional

import torch
import torch.distributed as dist


class _CpuPickler(pickle.Pickler):
    """Writes each tensor as its dtype, shape and bytes (a CPU copy), and
    each torch.device as a marker, both restored by
    `_DevicePlacingUnpickler`."""

    def persistent_id(self, obj):
        if isinstance(obj, torch.Tensor):
            t = obj.detach().cpu().contiguous().reshape(-1)
            return ("tensor", str(obj.dtype).split(".")[-1],
                    tuple(obj.shape), t.view(torch.uint8).numpy().tobytes())
        if isinstance(obj, torch.device):
            return ("device",)
        return None


class _DevicePlacingUnpickler(pickle.Unpickler):
    def __init__(self, f, device: torch.device):
        super().__init__(f)
        self.device = device

    def persistent_load(self, pid):
        if pid[0] == "device":
            return self.device
        if pid[0] == "tensor":
            _, dtype, shape, raw = pid
            dtype = getattr(torch, dtype)
            if raw:
                t = torch.frombuffer(bytearray(raw), dtype=dtype)
            else:
                t = torch.empty(0, dtype=dtype)
            return t.reshape(shape).to(self.device)
        raise pickle.UnpicklingError(f"unknown persistent id {pid[0]!r}")


def _dumps(obj: Any) -> bytes:
    buf = io.BytesIO()
    _CpuPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


def save_pytree_pickle(obj: Any, path: str,
                       parts: Optional[Iterable[Any]] = None) -> None:
    """Pickle ``obj`` to ``path``. When it cannot be pickled, raise
    TypeError naming the first of ``parts`` (a pipeline's operators) that
    cannot, and leave ``path`` untouched."""
    try:
        payload = _dumps(obj)
    except (pickle.PicklingError, TypeError, AttributeError) as err:
        for part in parts or ():
            try:
                _dumps(part)
            except (pickle.PicklingError, TypeError, AttributeError) as e:
                label = getattr(part, "label", type(part).__name__)
                raise TypeError(f"cannot save {label}: {e}") from e
        raise TypeError(f"cannot save {type(obj).__name__}: {err}") from err
    with open(path, "wb") as f:
        f.write(payload)


def load_pytree_pickle(path: str, device: torch.device) -> Any:
    """Unpickle ``path``, its tensors placed on ``device``."""
    with open(path, "rb") as f:
        return _DevicePlacingUnpickler(f, device).load()


# ------------------------------------------------------------- distributed

_DCP_FORMAT = "keystone-torch-dcp-v1"
_SKELETON = "skeleton.pkl"
_ARRAYS = "arrays"
_ID_FILE = "arrays_id.txt"


class _TensorExtractingPickler(_CpuPickler):
    """Writes each tensor as a key into ``self.tensors`` (first-seen
    order; a tensor met twice keeps one key)."""

    def __init__(self, f, tensors: Dict[str, torch.Tensor]):
        super().__init__(f, protocol=pickle.HIGHEST_PROTOCOL)
        self.tensors = tensors
        self._keys: Dict[int, str] = {}
        self._held: List[torch.Tensor] = []  # keeps ids unique

    def persistent_id(self, obj):
        if isinstance(obj, torch.Tensor):
            key = self._keys.get(id(obj))
            if key is None:
                key = self._keys[id(obj)] = f"t{len(self._keys)}"
                self._held.append(obj)
                self.tensors[key] = obj.detach().contiguous()
            return ("dcp", key)
        return super().persistent_id(obj)


class _TensorBindingUnpickler(_DevicePlacingUnpickler):
    def __init__(self, f, device: torch.device,
                 tensors: Dict[str, torch.Tensor]):
        super().__init__(f, device)
        self.tensors = tensors

    def persistent_load(self, pid):
        if pid[0] == "dcp":
            return self.tensors[pid[1]]
        return super().persistent_load(pid)


def _atomic_write(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def _rank() -> int:
    return dist.get_rank() if _distributed() else 0


def save_pytree_dcp(obj: Any, path: str) -> None:
    """Save ``obj`` under directory ``path``: its tensors through
    `torch.distributed.checkpoint`, the rest as a pickle (module
    docstring). Collective; ends in a barrier."""
    import torch.distributed.checkpoint as dcp

    from ..parallel.multihost import barrier

    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    buf = io.BytesIO()
    tensors: Dict[str, torch.Tensor] = {}
    _TensorExtractingPickler(buf, tensors).dump(obj)
    artifact_id = uuid.uuid4().hex
    if _rank() == 0:
        _atomic_write(os.path.join(path, _SKELETON), pickle.dumps({
            "format": _DCP_FORMAT,
            "artifact_id": artifact_id,
            "tensors": [(k, str(t.dtype).split(".")[-1], tuple(t.shape))
                        for k, t in tensors.items()],
            "payload": buf.getvalue(),
        }, protocol=pickle.HIGHEST_PROTOCOL))
    dcp.save(tensors, checkpoint_id=os.path.join(path, _ARRAYS),
             no_dist=not _distributed())
    if _rank() == 0:
        _atomic_write(os.path.join(path, _ID_FILE), artifact_id.encode())
    barrier()


def _read_skeleton(path: str) -> dict:
    try:
        with open(os.path.join(path, _SKELETON), "rb") as f:
            wrapper = pickle.load(f)
    except (OSError, pickle.UnpicklingError, EOFError, ValueError) as err:
        raise RuntimeError(f"{path}: unreadable {_SKELETON} ({err})") from err
    if not (isinstance(wrapper, dict)
            and wrapper.get("format") == _DCP_FORMAT):
        raise RuntimeError(f"{path} is not a {_DCP_FORMAT} artifact "
                           f"(corrupt or foreign {_SKELETON})")
    return wrapper


def load_pytree_dcp(path: str, device: torch.device) -> Any:
    """Load an object saved by `save_pytree_dcp`, its tensors on
    ``device``. Collective; ends in a barrier."""
    import torch.distributed.checkpoint as dcp

    from ..parallel.multihost import barrier

    path = os.path.abspath(path)
    wrapper = _read_skeleton(path)
    try:
        with open(os.path.join(path, _ID_FILE), "rb") as f:
            sidecar_id = f.read().decode("ascii", "replace").strip()
    except FileNotFoundError:
        sidecar_id = None
    if sidecar_id != wrapper["artifact_id"]:
        raise RuntimeError(
            f"torn checkpoint {path}: skeleton id {wrapper['artifact_id']} "
            f"does not match the sidecar's {sidecar_id!r} (interrupted "
            "save?)")
    arrays = os.path.join(path, _ARRAYS)
    stored = dcp.FileSystemReader(arrays).read_metadata().state_dict_metadata
    tensors = {}
    for key, dtype, shape in wrapper["tensors"]:
        meta = stored.get(key)
        if meta is None or tuple(meta.size) != tuple(shape) or str(
                meta.properties.dtype).split(".")[-1] != dtype:
            raise RuntimeError(
                f"corrupt checkpoint {path}: tensor {key} ({dtype}, "
                f"{tuple(shape)}) of the skeleton is not in {_ARRAYS}/ as "
                "such")
        tensors[key] = torch.empty(shape, dtype=getattr(torch, dtype),
                                   device=device)
    if len(stored) != len(tensors):
        raise RuntimeError(f"corrupt checkpoint {path}: {_ARRAYS}/ holds "
                           f"{len(stored)} tensors, the skeleton "
                           f"{len(tensors)}")
    dcp.load(tensors, checkpoint_id=arrays, no_dist=not _distributed())
    obj = _TensorBindingUnpickler(io.BytesIO(wrapper["payload"]), device,
                                  tensors).load()
    barrier()
    return obj


def is_dcp_artifact(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(
        os.path.join(path, _SKELETON))
