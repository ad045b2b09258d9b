"""FB+-tree core in PyTorch: the data structure, its builds and the batched
ops."""
from .batch_ops import (BuildReport, OpReport, insert_batch, lookup_batch,
                        range_scan, rebuild, remove_batch, traverse_probe,
                        update_batch)
from .baseline import VARIANTS, lookup_variant
from .branch import BranchStats, branch_level
from .convert import tree_from_numpy
from .fbtree import (FBTree, TreeConfig, bulk_build, sharded_partition,
                     stack_levels)
from .keys import KeySet, encode_int64, encode_uint64, make_keyset
from .leaf import probe
from .traverse import (DEFAULT_ENGINE, TraversalEngine, available_backends,
                       register_backend)

__all__ = [
    "FBTree", "TreeConfig", "bulk_build", "stack_levels", "sharded_partition",
    "tree_from_numpy", "KeySet", "make_keyset", "encode_uint64",
    "encode_int64", "branch_level", "BranchStats", "probe", "TraversalEngine",
    "DEFAULT_ENGINE", "register_backend", "available_backends",
    "lookup_batch", "update_batch", "insert_batch", "remove_batch",
    "range_scan", "rebuild", "traverse_probe", "OpReport", "BuildReport",
    "lookup_variant", "VARIANTS",
]
