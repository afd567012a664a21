"""Dense-similarity + top-k over a full corpus embedding matrix.

Replaces the reference's DenseReranker (per-candidate pure-python cosine,
retrieval_backend.py:186-247) with one device program:

  scores, ids = top_k(Q @ D^T)       Q: [B, d] queries, D: [N, d] corpus

Three implementations, oracle-tested against each other:

- `dense_topk_xla`: one matmul + ``lax.top_k``. XLA materializes the
  [B, N] score matrix in device memory. The exact oracle.
- `dense_topk_exact_tiled`: the same scores, selected in two levels — a
  ``top_k`` per corpus tile, then one over the tile winners. Exact by
  construction; each sort sees N/n_tiles keys instead of N.
- `dense_topk_approx`: matmul + ``lax.approx_max_k``. On the GPU and the
  CPU XLA lowers that op to its exact sort fallback, so it returns the
  exact top-k.

Corpus rows may be bf16 (the index storage dtype). The matmul precision is
named on every product (`_scores`): bf16 corpora multiply in bf16 with f32
accumulation; f32 corpora multiply at ``HIGHEST`` so that a GPU does not
round the operands to TF32.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

NEG_INF = -1e30


def _scores(q: jax.Array, d: jax.Array, precision) -> jax.Array:
    """[B, N] f32 inner products. ``precision=None`` picks it from the
    corpus dtype: bf16 rows take bf16 queries at ``DEFAULT`` (bf16
    products, f32 accumulation); anything else runs at ``HIGHEST``."""
    if precision is None:
        if d.dtype == jnp.bfloat16:
            q, precision = q.astype(jnp.bfloat16), jax.lax.Precision.DEFAULT
        else:
            precision = jax.lax.Precision.HIGHEST
    return jax.lax.dot_general(
        q, d, dimension_numbers=(((1,), (1,)), ((), ())),
        precision=precision, preferred_element_type=jnp.float32,
    )


@functools.partial(jax.jit, static_argnames=("k", "precision"))
def dense_topk_xla(
    q: jax.Array, d: jax.Array, k: int, precision=None
) -> Tuple[jax.Array, jax.Array]:
    """Return (scores [B, k] f32, ids [B, k] i32) of the top-k inner
    products: the exact oracle."""
    top_s, top_i = jax.lax.top_k(_scores(q, d, precision), k)
    return top_s.astype(jnp.float32), top_i.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("k", "n_tiles", "precision"))
def dense_topk_exact_tiled(
    q: jax.Array, d: jax.Array, k: int, n_tiles: int = 16, precision=None
) -> Tuple[jax.Array, jax.Array]:
    """Two-level EXACT top-k: per-tile ``top_k`` over corpus tiles, then a
    global ``top_k`` over the tile winners.

    Exact by construction — any global top-k element is inside its own
    tile's top-k — while each sort runs over N/n_tiles keys instead of N
    (the second-level sort sees only n_tiles*k keys). The [B, N] score
    matrix still materializes once, as in `dense_topk_xla`, so this
    targets the selection cost only. Tie-breaking: ids within a tile are
    ascending (lax.top_k is stable), but ties ACROSS tiles resolve by tile
    order of equal scores — same set, possibly different id order than
    single-level top_k at exact score ties.
    """
    B = q.shape[0]
    N = d.shape[0]
    if k > N:
        # single-level lax.top_k(scores, k) fails loudly when k > N; with
        # tiling the pad columns would silently surface as ids >= N instead
        raise ValueError(f"k={k} exceeds corpus rows N={N}")
    pad = (-N) % n_tiles
    scores = _scores(q, d, precision)
    if pad:
        scores = jnp.pad(scores, ((0, 0), (0, pad)),
                         constant_values=NEG_INF)
    tile = (N + pad) // n_tiles
    kt = min(k, tile)
    s3 = scores.reshape(B, n_tiles, tile)
    ts, ti = jax.lax.top_k(s3, kt)                      # [B, T, kt]
    gids = ti + (jnp.arange(n_tiles, dtype=jnp.int32) * tile)[None, :, None]
    flat_s = ts.reshape(B, n_tiles * kt)
    flat_i = gids.reshape(B, n_tiles * kt)
    top_s, pos = jax.lax.top_k(flat_s, k)
    top_i = jnp.take_along_axis(flat_i, pos, axis=1)
    return top_s.astype(jnp.float32), top_i.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("k", "recall_target"))
def dense_topk_approx(
    q: jax.Array, d: jax.Array, k: int, recall_target: float = 0.95
) -> Tuple[jax.Array, jax.Array]:
    """Matmul + ``lax.approx_max_k``. On the GPU and the CPU XLA lowers
    approx_max_k to an exact sort, so this equals `dense_topk_xla`."""
    top_s, top_i = jax.lax.approx_max_k(_scores(q, d, None), k,
                                        recall_target=recall_target)
    return top_s.astype(jnp.float32), top_i.astype(jnp.int32)


# The engine's full-corpus dense top-k: single-level XLA measured faster
# than the two-level path at the engine's shapes on the GPU (PERF.md).
dense_topk = dense_topk_xla
