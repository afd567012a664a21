from .topk import dense_topk, dense_topk_xla
from .bm25 import bm25_scores, Bm25DeviceIndex
from .graph import expand_frontier, hop_decay_table
from .fusion import fuse_channels, minmax_normalize

__all__ = [
    "Bm25DeviceIndex",
    "bm25_scores",
    "dense_topk",
    "dense_topk_xla",
    "expand_frontier",
    "fuse_channels",
    "hop_decay_table",
    "minmax_normalize",
]
