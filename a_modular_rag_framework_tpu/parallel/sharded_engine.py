"""ShardedDenseEngine — multi-chip dense retrieval serving.

The scale-out path of SURVEY.md §2b: corpus embeddings row-sharded over the
``data`` mesh axis, queries replicated, per-shard fused top-k merged with
one all_gather (`parallel.sharded.sharded_dense_topk`). On one
host this runs across the virtual CPU mesh for testing; on a pod slice the
same code spans real chips.

The hybrid channels (BM25/graph) stay single-chip for now — the dense
embedding matrix is the component that outgrows one HBM first (fullwiki
5M x 768 bf16 = 7.7GB; with f32 queries and growth, sharding it is the
unlock). Full hybrid sharding is a later-round item.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from ..core.dto import HitBatch
from ..index.packed import PackedIndex
from ..models.hash_embed import HashEmbedEncoder
from .mesh import build_mesh
from .sharded import shard_corpus_rows, sharded_dense_topk


class ShardedDenseEngine:
    def __init__(
        self,
        index: PackedIndex,
        *,
        mesh: Optional[Mesh] = None,
        axis: str = "data",
        encoder: Optional[Any] = None,
        batch_buckets: Sequence[int] = (1, 8, 64, 256),
    ):
        self.index = index
        self.mesh = mesh or build_mesh({axis: -1})
        self.axis = axis
        self.encoder = encoder or HashEmbedEncoder(dim=index.embed_dim or 64)
        self.batch_buckets = tuple(batch_buckets)

        emb = np.asarray(index.device_embeddings(), dtype=np.float32)
        norms = np.linalg.norm(emb, axis=1, keepdims=True)
        emb = emb / np.maximum(norms, 1e-9)
        self._n = emb.shape[0]
        # pad rows to a multiple of the shard count (zero rows never win)
        n_shards = self.mesh.shape[axis]
        pad = (-self._n) % n_shards
        if pad:
            emb = np.concatenate(
                [emb, np.zeros((pad, emb.shape[1]), dtype=emb.dtype)], axis=0
            )
        self._emb_sharded = shard_corpus_rows(jnp.asarray(emb), self.mesh, axis)

    @property
    def n_shards(self) -> int:
        return self.mesh.shape[self.axis]

    def _bucket(self, b: int) -> int:
        for s in self.batch_buckets:
            if b <= s:
                return s
        return b

    def query_batch(self, queries: Sequence[str], *, top_k: int = 10) -> HitBatch:
        B_real = len(queries)
        k = min(int(top_k), self._n)
        if B_real == 0 or self._n == 0:
            return HitBatch(ids=np.full((B_real, max(k, 1)), -1, np.int32),
                            scores=np.zeros((B_real, max(k, 1)), np.float32))
        B = self._bucket(B_real)
        padded = list(queries) + [""] * (B - B_real)
        q = jnp.asarray(np.asarray(self.encoder.encode_texts(padded),
                                   dtype=np.float32))
        s, i = sharded_dense_topk(q, self._emb_sharded, k, self.mesh,
                                  axis=self.axis)
        s = np.asarray(s)[:B_real]
        i = np.asarray(i)[:B_real]
        # padded zero rows can only surface when k ~ N; mask them
        valid = i < self._n
        return HitBatch(ids=np.where(valid, i, -1).astype(np.int32),
                        scores=np.where(valid, s, 0.0).astype(np.float32))
