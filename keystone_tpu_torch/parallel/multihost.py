"""Multi-process execution: one process per card, the analog of the
reference's Spark cluster (a coordinator and executors over the
network).

Counterpart of `keystone_tpu/parallel/multihost.py` (`:1-146`). JAX runs
one controller per host over a global `Mesh`; the port runs one process
per card in a `torch.distributed` group, and the same pipeline code on
each, every row reduction an explicit collective (`collectives.py`).

  - `init_multihost()` — idempotent process-group setup; a no-op
    without a coordinator, so library code can call it
    unconditionally. NCCL where the device is the card (this process's
    card is ``cuda:<local rank>``), gloo where the caller asked for the
    CPU; no other pairing. Its ``timeout`` bounds every collective, so a
    lost peer fails loudly instead of hanging.
  - `global_data_mesh(model_shards)` — a ``(world/m, m)`` mesh over
    every rank, on the ``data`` axis alone where ``m`` is 1.
  - `dataset_from_process_local()` — a global `Dataset` from each
    process's locally loaded rows.
  - `barrier()` — a cross-process sync point (≈ a Spark stage
    boundary).
"""

from __future__ import annotations

import datetime
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from . import mesh as meshlib

#: seconds a collective may wait for its peers before it fails
DEFAULT_TIMEOUT_S = 600.0


def _world() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   device="cuda",
                   timeout: float = DEFAULT_TIMEOUT_S,
                   backend: Optional[str] = None) -> int:
    """Join (or skip joining) the job; returns the group's size.

    Without ``coordinator_address`` (``host:port``) this is a no-op
    returning the current size (1 without a group), and it does not
    latch, so a later call with a coordinator still joins. Joining:
    ``device="cuda"`` sets this process's card, ``cuda:<local rank>``
    (``process_id`` modulo the cards present), and opens an NCCL
    group, raising where CUDA or NCCL is missing; ``device="cpu"`` opens
    a gloo group. ``backend="gloo"`` with ``device="cuda"`` opens a gloo
    group over the card's tensors: NCCL puts no two ranks on one card,
    so that is how ranks share one (its collectives pass through host
    memory). A second call once joined returns the size."""
    if coordinator_address is None or (
            dist.is_available() and dist.is_initialized()):
        return _world()
    if num_processes is None or process_id is None:
        raise ValueError("init_multihost: a coordinator needs "
                         "num_processes and process_id")
    dev = torch.device(device)
    kwargs = {}
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_multihost: device 'cuda' requested but "
                               "CUDA is not available; pass device='cpu' "
                               "for a gloo group on the CPU")
        if not dist.is_nccl_available():
            raise RuntimeError("init_multihost: device 'cuda' needs NCCL, "
                               "which this torch build lacks")
        local = process_id % torch.cuda.device_count()
        torch.cuda.set_device(local)
        if backend is None:
            backend = "nccl"
            kwargs["device_id"] = torch.device("cuda", local)
        elif backend == "gloo":
            meshlib._group_device = "cuda"
        else:
            raise ValueError(f"init_multihost: backend {backend!r} on "
                             "the card (nccl or gloo)")
    elif dev.type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"init_multihost: backend {backend!r} on "
                             "the CPU (gloo only)")
        backend = "gloo"
    else:
        raise ValueError(f"init_multihost: unsupported device {device!r}")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout), **kwargs)
    return _world()


def global_data_mesh(model_shards: int = 1):
    """A mesh over every rank of the job (`:74-96`): ``(world/m, m)``
    over ``(data, model)`` for ``model_shards`` m > 1, else the whole
    job on ``data``. ``m`` must divide the world."""
    if model_shards != 1:
        world = _world()
        if model_shards < 1 or world % model_shards:
            raise ValueError(f"{model_shards} model shards do not divide "
                             f"the job's {world} ranks")
        return meshlib.make_mesh((world // model_shards, model_shards),
                                 (meshlib.DATA_AXIS, meshlib.MODEL_AXIS))
    return meshlib.make_mesh()


def dataset_from_process_local(local_rows, global_count: Optional[int] = None,
                               mesh=None, device=None):
    """A global data-sharded `Dataset` from this process's rows
    (`:99-131`). Each process loads its own split and passes the same
    number of rows (pad the last split); the global rows are the splits
    in rank order, of which the first ``global_count`` (default all) are
    valid: ``ceil(global_count / shards) · shards`` must equal the rows
    in all, as `Dataset` pads them. The rows go to ``device``: by
    default the mesh's device type (this rank's card, ``cuda:<local
    rank>``, under NCCL; the CPU under gloo), and the card without a
    mesh, where they make one process's `Dataset`."""
    from ..data.dataset import Dataset  # deferred: dataset imports parallel

    mesh = mesh if mesh is not None else meshlib.current_mesh()
    if device is None:
        device = meshlib.mesh_device(mesh)
    if isinstance(local_rows, torch.Tensor):
        rows = local_rows
    else:
        rows = torch.from_numpy(np.ascontiguousarray(local_rows))
    rows = rows.to(resolve_device(device))
    shards = meshlib.n_data_shards(mesh)
    if mesh is None:
        n = rows.shape[0] if global_count is None else global_count
        return Dataset(rows, count=n)
    total = rows.shape[0] * shards
    n = total if global_count is None else int(global_count)
    if -(-n // shards) * shards != total:
        raise ValueError(
            f"global rows {total} must equal ceil({n}/{shards})·{shards}; "
            "pad per-process splits evenly")
    return Dataset(rows, count=n, mesh=mesh, placed=True)


def barrier() -> None:
    """Cross-process sync (≈ Spark stage boundary): every process must
    reach it before any can pass. Without a group, a no-op."""
    if not (dist.is_available() and dist.is_initialized()):
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
