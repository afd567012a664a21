"""Semantic-similarity edge construction on device.

Replaces the reference's O(n^2) python-pairs cosine loop
(edge_builder.py:146-169) with one batched program: normalize the sentence
embedding matrix, compute E_n @ E_n^T in one matmul, threshold, and (optionally)
keep only the top-k strongest partners per node. Host code extracts the
surviving (i, j, sim) triplets for graph assembly.
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

NEG_INF = jnp.float32(-1e30)


@functools.partial(jax.jit, static_argnames=("top_k_per_node",))
def semantic_sim_matrix(
    emb: jax.Array,  # [n, d] f32 sentence embeddings
    *,
    threshold: float,
    top_k_per_node: int = 0,
) -> jax.Array:
    """Return [n, n] f32: pairwise cosine where >= threshold, else 0.

    Diagonal and sub-threshold pairs are zeroed. With ``top_k_per_node`` > 0,
    each row keeps only its k strongest partners (device-side sparsification;
    the reference prunes per-node after voting, edge_builder.py:184-198).
    """
    norms = jnp.sqrt(jnp.sum(emb * emb, axis=1, keepdims=True))
    en = emb / jnp.maximum(norms, 1e-9)
    # HIGHEST precision: exact-threshold semantics matter here (a 0.9 cosine
    # cut with bf16 multiplies would flip borderline edges), and per-question
    # graphs are small so the f32 matmul cost is negligible.
    sims = jnp.dot(en, en.T, precision=jax.lax.Precision.HIGHEST,
                   preferred_element_type=jnp.float32)
    n = sims.shape[0]
    eye = jnp.eye(n, dtype=jnp.bool_)
    # rows with zero norm have no direction: their sims are ~0 already
    keep = (sims >= threshold) & (~eye)
    zero_norm = (norms[:, 0] <= 1e-9)
    keep = keep & (~zero_norm[:, None]) & (~zero_norm[None, :])
    out = jnp.where(keep, sims, 0.0)
    if top_k_per_node and top_k_per_node < n:
        kth = jax.lax.top_k(out, top_k_per_node)[0][:, -1:]
        out = jnp.where(out >= jnp.maximum(kth, 1e-30), out, 0.0)
    return out


def _bucket(n: int) -> int:
    b = 16
    while b < n:
        b *= 2
    return b


def semantic_edges(
    emb: np.ndarray,
    *,
    threshold: float,
    top_k_per_node: int = 0,
) -> List[Tuple[int, int, float]]:
    """Host wrapper: unique upper-triangle (i, j, sim) pairs above threshold
    (the reference iterates itertools.combinations — i < j only).

    Rows are padded to a power-of-two bucket so per-question graphs of
    different sizes reuse one compiled program (zero-padded rows have zero
    norm and produce no edges by construction)."""
    n = emb.shape[0]
    if n < 2:
        return []
    nb = _bucket(n)
    if nb > n:
        emb = np.concatenate(
            [emb, np.zeros((nb - n, emb.shape[1]), dtype=emb.dtype)], axis=0
        )
    S = np.asarray(semantic_sim_matrix(jnp.asarray(emb, dtype=jnp.float32),
                                       threshold=threshold,
                                       top_k_per_node=top_k_per_node))[:n, :n]
    iu = np.triu_indices(n, k=1)
    vals = S[iu]
    mask = vals > 0
    return [(int(i), int(j), float(v)) for i, j, v in
            zip(iu[0][mask], iu[1][mask], vals[mask])]
