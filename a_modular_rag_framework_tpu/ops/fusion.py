"""Multi-channel score fusion on device.

Replaces the reference's dict-based fuse (retrieval_backend.py:296-372):
per-channel min-max normalization over each channel's own candidate pool,
alpha-weighted sum over the union, final top-k — one jitted program over
dense [N] channel scores with presence masks.

Exact semantics parity:
  - min-max is computed over PRESENT entries only (the channel's pool);
  - if vmax <= vmin the whole channel normalizes to 0 (reference
    _minmax_norm, retrieval_backend.py:296-301);
  - absent entries contribute 0 to the fused score;
  - the fused candidate set is the union of channel pools; entries present
    in no channel never reach the top-k (masked to -inf).
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

NEG_INF = -1e30  # plain float: jnp scalars can't be captured by pallas kernels


def reorder_hits(
    top_s: jax.Array,     # [B, k] f32 fused selection scores
    top_i: jax.Array,     # [B, k] i32 global ids (-1 pad)
    norms_at: jax.Array,  # [B, 3, k] f32 per-channel norms at the hits
    order_alphas: Tuple[float, float, float],
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Re-rank an already-selected top-k by a second fusion weighting.

    Two-stage fusion: the top-k MEMBERSHIP comes from the engine's
    selection alphas (recall-optimal), the final ORDER from
    ``order_alphas`` (precision/MRR-optimal). Measured round 3: selecting
    with 0.15/0.70/0.15 and ordering with the reference-parity
    0.4/0.2/0.4 gives the tuned weights' recall@10 AND the parity
    weights' MRR on every corpus family (see docs/ROUND3.md).

    Returns the permuted (top_s, top_i, norms_at), where ``top_s`` becomes
    the ordering score (hits must rank by their reported score); padding
    rows (id -1) sink to the end. One stable variadic sort of k elements —
    negligible next to the selection top-k.
    """
    ow = jnp.asarray(order_alphas, dtype=jnp.float32)
    order_s = jnp.einsum("bck,c->bk", norms_at, ow)
    ok = top_i >= 0
    key = jnp.where(ok, -order_s, -jnp.float32(NEG_INF))
    _, order_out, ids_out, nt, ng, nd = jax.lax.sort(
        (key, jnp.where(ok, order_s, 0.0), top_i,
         norms_at[:, 0, :], norms_at[:, 1, :], norms_at[:, 2, :]),
        dimension=1, num_keys=1)
    return order_out, ids_out, jnp.stack([nt, ng, nd], axis=1)


def minmax_normalize(scores: jax.Array, present: jax.Array) -> jax.Array:
    """Min-max over present entries; all-0 when the pool is degenerate."""
    big = jnp.float32(1e30)
    vmin = jnp.min(jnp.where(present, scores, big))
    vmax = jnp.max(jnp.where(present, scores, -big))
    span = vmax - vmin
    ok = span > 0
    normed = jnp.where(present, (scores - vmin) / jnp.where(ok, span, 1.0), 0.0)
    return jnp.where(ok, normed, jnp.zeros_like(scores))


def minmax_rows(v: jax.Array, valid: jax.Array) -> jax.Array:
    """Row-wise min-max over valid entries; degenerate rows normalize to 0."""
    big = jnp.float32(1e30)
    lo = jnp.min(jnp.where(valid, v, big), axis=1, keepdims=True)
    hi = jnp.max(jnp.where(valid, v, -big), axis=1, keepdims=True)
    span = hi - lo
    ok = span > 0
    out = jnp.where(valid, (v - lo) / jnp.where(ok, span, 1.0), 0.0)
    return jnp.where(ok, out, jnp.zeros_like(out))


def fuse_pools_compact(
    pool_s: jax.Array,       # [B, P] f32 text-pool scores (exact BM25)
    pool_i: jax.Array,       # [B, P] i32 text-pool global ids
    pool_valid: jax.Array,   # [B, P] bool
    dense_pool: jax.Array,   # [B, P] f32 cosine at text-pool ids
    t_graph_raw: jax.Array,  # [B, P] f32 raw graph score at text-pool ids
    g_pool_s: jax.Array,     # [B, G] f32 graph-pool scores
    g_pool_i: jax.Array,     # [B, G] i32 graph-pool global ids
    g_valid: jax.Array,      # [B, G] bool
    *,
    alphas: jax.Array,       # [3] f32 (text, graph, dense)
    k: int,
    n: int,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Pool-compact fusion: operates on the P+G candidate union — no [B, N]
    channel buffers, no scatters (sort-dedup instead).

    Semantics identical to `fuse_channels` over dense buffers: per-channel
    min-max over each channel's own pool; ids only in the graph pool
    contribute a_graph * norm_graph alone; ids in the text pool gather
    their graph value when (and only when) they are graph-pool members.

    Returns (top_s [B, k], top_i [B, k] i32, norms_at [B, 3, k]).
    Shared by the single-chip engine and the sharded hybrid engine — both
    run the same fusion bit-for-bit once their pools agree.
    """
    B = pool_s.shape[0]
    big = jnp.float32(1e30)
    # channel norms over their own pools
    nt = minmax_rows(pool_s, pool_valid)
    nd = minmax_rows(dense_pool, pool_valid)
    ng_pool = minmax_rows(g_pool_s, g_valid)
    # graph values at text-pool ids, normalized against the graph pool's
    # min-max iff the id is a graph-pool member (>= the pool's min score)
    g_lo = jnp.min(jnp.where(g_valid, g_pool_s, big), axis=1, keepdims=True)
    g_hi = jnp.max(jnp.where(g_valid, g_pool_s, -big), axis=1, keepdims=True)
    g_span_ok = (g_hi - g_lo) > 0
    in_gpool = pool_valid & (t_graph_raw > 0) & (t_graph_raw >= g_lo)
    ng_text = jnp.where(
        in_gpool & g_span_ok,
        (t_graph_raw - g_lo) / jnp.where(g_span_ok, g_hi - g_lo, 1.0),
        0.0,
    )

    fused_text = alphas[0] * nt + alphas[1] * ng_text + alphas[2] * nd
    fused_g = alphas[1] * ng_pool

    # union with dedup: sort by (id, text-first); drop non-first entries of
    # equal ids (a dup is always text+graph for one id)
    ids_cat = jnp.concatenate([pool_i, g_pool_i], axis=1)
    flag = jnp.concatenate(
        [jnp.zeros_like(pool_i), jnp.ones_like(g_pool_i)], axis=1
    )
    valid_cat = jnp.concatenate([pool_valid, g_valid], axis=1)
    fused_cat = jnp.concatenate([fused_text, fused_g], axis=1)
    nt_cat = jnp.concatenate([nt, jnp.zeros_like(ng_pool)], axis=1)
    ng_cat = jnp.concatenate([ng_text, ng_pool], axis=1)
    nd_cat = jnp.concatenate([nd, jnp.zeros_like(ng_pool)], axis=1)

    sort_ids = jnp.where(valid_cat, ids_cat, n + 1)
    # int32 key is safe: ids < 2^30 (1B rows) leaves room for the flag bit.
    # (id, flag) is unique per row (each pool holds distinct ids), so ONE
    # variadic sort carrying all payloads replaces argsort + 5
    # take_along_axis gathers with identical results (the sort is one HLO
    # and the payloads ride it instead of 5 row-gathers). The
    # sorted ids are recovered from the key by a shift rather than riding
    # as an extra payload column.
    key = sort_ids * 2 + flag
    key_s, fused_s, nt_s, ng_s, nd_s = jax.lax.sort(
        (key, fused_cat, nt_cat, ng_cat, nd_cat), dimension=1, num_keys=1)
    ids_s = key_s >> 1
    dup = jnp.concatenate(
        [jnp.zeros((B, 1), dtype=jnp.bool_),
         ids_s[:, 1:] == ids_s[:, :-1]], axis=1,
    )
    alive = (ids_s <= n - 1 if n else ids_s < 0) & (~dup)
    fused_m = jnp.where(alive, fused_s, NEG_INF)

    top_s, pos = jax.lax.top_k(fused_m, min(k, fused_m.shape[1]))
    ok = top_s > NEG_INF / 2
    top_i = jnp.where(ok, jnp.take_along_axis(ids_s, pos, axis=1), -1)
    top_s = jnp.where(ok, top_s, 0.0)
    norms_at = jnp.stack(
        [jnp.take_along_axis(nt_s, pos, axis=1),
         jnp.take_along_axis(ng_s, pos, axis=1),
         jnp.take_along_axis(nd_s, pos, axis=1)], axis=1,
    )  # [B, 3, k]
    pad_k = k - top_s.shape[1]
    if pad_k > 0:
        top_s = jnp.pad(top_s, ((0, 0), (0, pad_k)))
        top_i = jnp.pad(top_i, ((0, 0), (0, pad_k)), constant_values=-1)
        norms_at = jnp.pad(norms_at, ((0, 0), (0, 0), (0, pad_k)))
    return top_s, top_i.astype(jnp.int32), norms_at


@functools.partial(jax.jit, static_argnames=("k",))
def fuse_channels(
    channel_scores: jax.Array,  # [C, N] f32
    channel_present: jax.Array,  # [C, N] bool
    alphas: jax.Array,  # [C] f32
    *,
    k: int,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Return (top scores [k], top ids [k], normalized [C, N]).

    Padded output slots (union smaller than k) carry id -1.
    """
    normed = jax.vmap(minmax_normalize)(channel_scores, channel_present)
    fused = jnp.einsum("c,cn->n", alphas, normed)
    union = jnp.any(channel_present, axis=0)
    masked = jnp.where(union, fused, NEG_INF)
    top_s, top_i = jax.lax.top_k(masked, k)
    valid = top_s > NEG_INF / 2
    return (
        jnp.where(valid, top_s, 0.0),
        jnp.where(valid, top_i, -1).astype(jnp.int32),
        normed,
    )
