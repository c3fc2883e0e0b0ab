"""Saving and loading fitted pipelines with plain `pickle`.

Counterpart of `keystone_tpu/utils/serialization.py:37-60`
(`save_pytree_pickle`, `load_pytree_pickle`), which pickles with
cloudpickle and writes device arrays as host numpy. Here every tensor is
written as a CPU tensor (and every `torch.device` by name), and `load`
places them on the device asked for. Plain pickle carries no lambdas or
locally defined classes: `save` then raises TypeError naming the part
that cannot be pickled and writes nothing. The JAX package's orbax
format, its multi-host path, has no counterpart yet.
"""

from __future__ import annotations

import io
import pickle
from typing import Any, Iterable, Optional

import torch


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
