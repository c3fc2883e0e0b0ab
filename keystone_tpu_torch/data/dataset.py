"""Device-resident dataset handle.

Counterpart of `keystone_tpu/data/dataset.py::Dataset` (`:95-276`),
single-device part only. The JAX `Dataset` pads its leading axis to a
multiple of the mesh's data shards; with one device and no mesh there is
nothing to pad, so ``padded_count == count`` and ``mask`` is all ones.
Both stay for API parity.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


class Dataset:
    """A tensor whose leading axis is the examples, on one device."""

    is_dataset = True

    def __init__(self, data, count: Optional[int] = None,
                 device: DeviceLike = None):
        """``data``: a tensor or an array. ``device``: where the rows
        live; None keeps a tensor where it is and puts anything else on
        the card."""
        if isinstance(data, torch.Tensor):
            dev = resolve_device(data.device if device is None else device)
            data = data.to(dev)
        else:
            dev = resolve_device(device)
            data = torch.as_tensor(np.asarray(data), device=dev)
        n = data.shape[0]
        self.count = n if count is None else int(count)
        if self.count > n:
            raise ValueError("count exceeds data length")
        self.data = data[: self.count]

    @property
    def array(self) -> torch.Tensor:
        return self.data

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def padded_count(self) -> int:
        return self.data.shape[0]

    @property
    def mask(self) -> torch.Tensor:
        """Validity mask over the rows: all ones on one device."""
        return torch.ones(self.padded_count, dtype=torch.bool,
                          device=self.device)

    def numpy(self) -> np.ndarray:
        """Host copy (≈ `collect`)."""
        return self.data.detach().cpu().numpy()

    def __len__(self) -> int:
        return self.count

    def map_batches(self, fn: Callable[[torch.Tensor], torch.Tensor],
                    count: Optional[int] = None) -> "Dataset":
        """Apply a whole-batch function to the rows."""
        return self.with_data(fn(self.data), count=count)

    def with_data(self, data: torch.Tensor,
                  count: Optional[int] = None) -> "Dataset":
        """New Dataset over ``data`` with this one's count."""
        return Dataset(data, count=self.count if count is None else count)

    def sync(self) -> "Dataset":
        """Wait until the device has produced the rows (a timing fence)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def take(self, k: int) -> np.ndarray:
        return self.data[: min(k, self.count)].detach().cpu().numpy()

    def __repr__(self) -> str:
        return (f"Dataset(count={self.count}, shape={tuple(self.data.shape)}, "
                f"device={self.device})")
