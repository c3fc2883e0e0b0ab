"""Mesh, collectives and multi-process layers on `torch.distributed`.

Counterpart of `keystone_tpu/parallel/__init__.py` (`:1-59`), its export
list less the names of `NamedSharding`s (`data_sharding`,
`replicated_sharding`, `spec_of_array`: a `Dataset`'s placement is its
``spec``), plus the static tier's `MeshLayout` and `layout_of` and the
model axis's `all_gather_columns` and `gather_block`, the row
gathers by global index the data-axis estimators take, `gather_rows`
and `collect_rows`, and the host gathers the text side's fits take,
`all_gather_objects` and `merge_counts`.
"""

from . import mesh
from .collectives import (
    all_gather_columns,
    all_gather_objects,
    all_gather_rows,
    all_reduce,
    broadcast,
    co_sharded,
    collect_rows,
    gather_block,
    gather_rows,
    merge_counts,
    psum,
    reshard,
    reshard_tree,
    tree_aggregate,
    tree_reduce_sum,
)
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    MeshLayout,
    P,
    PartitionSpec,
    collective_cost,
    current_mesh,
    feature_sharding,
    layout_of,
    make_mesh,
    model_rank,
    n_data_shards,
    n_model_shards,
    replicate,
    reset_default_mesh,
    spec_axes,
    spec_shards,
    specs_equal,
    use_mesh,
)
from .multihost import (
    barrier,
    dataset_from_process_local,
    global_data_mesh,
    init_multihost,
)

__all__ = [
    "mesh",
    "DATA_AXIS",
    "MODEL_AXIS",
    "MeshLayout",
    "P",
    "PartitionSpec",
    "collective_cost",
    "current_mesh",
    "feature_sharding",
    "layout_of",
    "make_mesh",
    "model_rank",
    "n_data_shards",
    "n_model_shards",
    "replicate",
    "reset_default_mesh",
    "spec_axes",
    "spec_shards",
    "specs_equal",
    "use_mesh",
    "all_gather_columns",
    "all_gather_objects",
    "all_gather_rows",
    "all_reduce",
    "broadcast",
    "co_sharded",
    "collect_rows",
    "gather_block",
    "gather_rows",
    "merge_counts",
    "psum",
    "reshard",
    "reshard_tree",
    "tree_aggregate",
    "tree_reduce_sum",
    "barrier",
    "dataset_from_process_local",
    "global_data_mesh",
    "init_multihost",
]
