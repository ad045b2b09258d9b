"""FB+-tree core in PyTorch: the data structure and the batched lookup."""
from .batch_ops import OpReport, lookup_batch, traverse_probe
from .branch import BranchStats, branch_level
from .convert import tree_from_numpy
from .fbtree import FBTree, TreeConfig, bulk_build, stack_levels
from .keys import KeySet, encode_int64, encode_uint64, make_keyset
from .leaf import probe
from .traverse import (DEFAULT_ENGINE, TraversalEngine, available_backends,
                       register_backend)

__all__ = [
    "FBTree", "TreeConfig", "bulk_build", "stack_levels", "tree_from_numpy",
    "KeySet", "make_keyset", "encode_uint64", "encode_int64", "branch_level",
    "BranchStats", "probe", "TraversalEngine", "DEFAULT_ENGINE",
    "register_backend", "available_backends", "lookup_batch",
    "traverse_probe", "OpReport",
]
