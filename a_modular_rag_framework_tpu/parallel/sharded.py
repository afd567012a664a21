"""Sharded dense retrieval: corpus rows over the ``data`` mesh axis.

The index-sharding design of SURVEY.md §2b: the corpus embedding matrix is
row-sharded across devices (`NamedSharding` on axis 0); queries are
replicated; each device computes a local fused matmul+top-k over its shard;
per-shard candidates are merged into global top-k with one `all_gather`. No [B, N] score matrix ever exists, on any chip.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.topk import dense_topk_xla


def shard_corpus_rows(emb, mesh: Mesh, axis: str = "data"):
    """Place [N, d] corpus embeddings row-sharded over ``axis``.

    N must divide evenly by the axis size (pad with zero rows upstream)."""
    return jax.device_put(emb, NamedSharding(mesh, P(axis, None)))


def sharded_dense_topk(
    q: jax.Array,
    emb_sharded: jax.Array,
    k: int,
    mesh: Mesh,
    axis: str = "data",
    precision=None,
) -> Tuple[jax.Array, jax.Array]:
    """Global top-k over a row-sharded corpus.

    Per shard: local scores [B, N/s] -> local top-k (ids offset to global
    rows) -> all_gather over ``axis`` -> merge [B, s*k] -> global top-k.
    The gather moves only s*k candidates per query, not the score matrix.
    """
    n_shards = mesh.shape[axis]
    local_rows = emb_sharded.shape[0] // n_shards

    def local_fn(q_rep, emb_local):
        s, i = dense_topk_xla(q_rep, emb_local, k, precision=precision)
        offset = jax.lax.axis_index(axis).astype(jnp.int32) * local_rows
        i = jnp.where(i >= 0, i + offset, -1)
        # gather every shard's candidates: [s, B, k] -> merge on each device
        all_s = jax.lax.all_gather(s, axis)
        all_i = jax.lax.all_gather(i, axis)
        B = q_rep.shape[0]
        cat_s = jnp.moveaxis(all_s, 0, 1).reshape(B, n_shards * k)
        cat_i = jnp.moveaxis(all_i, 0, 1).reshape(B, n_shards * k)
        top_s, top_i = jax.lax.top_k(cat_s, k)
        picked = jnp.take_along_axis(cat_i, top_i, axis=1)
        return top_s, picked

    fn = jax.jit(
        jax.shard_map(
            local_fn,
            mesh=mesh,
            in_specs=(P(), P(axis, None)),
            out_specs=(P(), P()),
            # outputs are value-replicated after the all_gather+merge, but
            # the static checker can't prove it (axis_index taints them)
            check_vma=False,
        )
    )
    return fn(q, emb_sharded)


# ---------------- learned sparse (SPLADE) channel ----------------


def shard_splade_postings(index, n_shards: int):
    """Partition an impact CSR (`ops.splade.SpladeDeviceIndex`) by doc
    ranges for row-sharded multi-chip scoring.

    Doc d belongs to shard d // rows_per_shard (n_docs padded up to a
    multiple of n_shards). Each shard gets its OWN CSR over local doc
    rows — postings keep their global impact-descending order within a
    term (a stable filter preserves it), so per-shard windowed scoring
    sees each term's locally-best postings first, exactly like the
    single-chip layout. Per-shard arrays pad to the max shard posting
    count and stack to [S, Pmax] / [S, V+1] for `P('data', None)`
    placement.

    Returns (doc_ids [S, Pmax] i32 local rows, impacts [S, Pmax] f32,
    row_ptr [S, V+1] i32, rows_per_shard).
    """
    import numpy as np

    V = index.row_ptr.shape[0] - 1
    rows_per_shard = -(-index.n_docs // n_shards)
    shard_of = index.doc_ids // rows_per_shard
    per_doc_local = index.doc_ids - shard_of * rows_per_shard

    # per (shard, term) posting counts -> per-shard CSR row pointers
    term_of = np.repeat(np.arange(V, dtype=np.int64),
                        np.diff(index.row_ptr).astype(np.int64))
    counts = np.zeros((n_shards, V), dtype=np.int64)
    np.add.at(counts, (shard_of, term_of), 1)
    row_ptrs = np.zeros((n_shards, V + 1), dtype=np.int32)
    np.cumsum(counts, axis=1, out=row_ptrs[:, 1:])

    p_max = max(int(row_ptrs[:, -1].max()), 1)
    doc_ids = np.zeros((n_shards, p_max), dtype=np.int32)
    impacts = np.zeros((n_shards, p_max), dtype=np.float32)
    # stable partition: order by (shard, term, original position) keeps the
    # impact-descending order inside each (shard, term) run
    order = np.lexsort((np.arange(term_of.shape[0]), term_of, shard_of))
    so, to = shard_of[order], term_of[order]
    # position within the destination shard = running index per shard
    shard_starts = np.searchsorted(so, np.arange(n_shards))
    pos = np.arange(order.shape[0]) - shard_starts[so]
    doc_ids[so, pos] = per_doc_local[order]
    impacts[so, pos] = index.impacts[order]
    return doc_ids, impacts, row_ptrs, rows_per_shard


def sharded_splade_topk(
    term_ids: jax.Array,      # [B, T] i32, -1 padded (replicated)
    term_weights: jax.Array,  # [B, T] f32 >= 0 (replicated)
    doc_ids,                  # [S, Pmax] from shard_splade_postings
    impacts,                  # [S, Pmax]
    row_ptrs,                 # [S, V+1]
    *,
    mesh: Mesh,
    rows_per_shard: int,
    n_docs: int,
    k: int,
    term_topm: int = 256,
    axis: str = "data",
) -> Tuple[jax.Array, jax.Array]:
    """Global learned-sparse top-k over doc-range-sharded impact postings.

    Per shard: windowed posting scoring (`ops.bm25.bm25_topk_sorted` with
    per-term query weights) over the LOCAL CSR -> local top-k -> ids
    offset to global rows -> `all_gather` -> merge. Only s*k
    candidates move between chips. Exact vs the single-chip scorer
    whenever term_topm covers each term's local posting lists (same
    windowing contract as single-chip)."""
    from ..ops.bm25 import bm25_topk_sorted

    n_shards = mesh.shape[axis]

    def local_fn(t_ids, t_w, d_loc, imp_loc, rp_loc):
        d_loc, imp_loc, rp_loc = d_loc[0], imp_loc[0], rp_loc[0]
        B, T = t_ids.shape
        s, i = bm25_topk_sorted(
            t_ids.reshape(B, 1, T), d_loc, imp_loc, rp_loc,
            n_docs=rows_per_shard,
            term_topm=min(term_topm, rows_per_shard), pool_k=k,
            term_weights=t_w.reshape(B, 1, T))
        offset = jax.lax.axis_index(axis).astype(jnp.int32) * rows_per_shard
        gi = jnp.where(i >= 0, i + offset, -1)
        gi = jnp.where(gi >= n_docs, -1, gi)  # padded tail rows
        all_s = jax.lax.all_gather(jnp.where(gi >= 0, s, 0.0), axis)
        all_i = jax.lax.all_gather(gi, axis)
        cat_s = jnp.moveaxis(all_s, 0, 1).reshape(B, n_shards * k)
        cat_i = jnp.moveaxis(all_i, 0, 1).reshape(B, n_shards * k)
        top_s, pos = jax.lax.top_k(cat_s, k)
        picked = jnp.take_along_axis(cat_i, pos, axis=1)
        picked = jnp.where(top_s > 0, picked, -1)
        return top_s, picked

    fn = jax.jit(
        jax.shard_map(
            local_fn,
            mesh=mesh,
            in_specs=(P(), P(), P(axis, None), P(axis, None),
                      P(axis, None)),
            out_specs=(P(), P()),
            check_vma=False,
        )
    )
    return fn(term_ids, term_weights, doc_ids, impacts, row_ptrs)
