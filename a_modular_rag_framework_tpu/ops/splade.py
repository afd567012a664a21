"""Learned-sparse (SPLADE) retrieval over impact-sorted CSR postings.

The doc side runs the expansion model over the corpus in device batches at
index-build time and stores each kept term's postings as (doc id, impact)
sorted by impact descending — the exact layout the BM25 channel uses for
its precomputed contributions (`ops/bm25.Bm25DeviceIndex.ensure_scores`),
so query scoring reuses `bm25_topk_sorted` verbatim with the per-term
query weights riding its ``term_weights`` seam:

    score(q, d) = sum_t w_q(t) * impact_d(t)

The query side is ONE jitted device program: hashed token ids -> trunk ->
expansion head -> top-q term select -> posting-window gather -> sort /
segment-sum -> top-k docs. No host work between the encoder and the
ranked ids beyond the tokenizer.

Reference contrast: the reference's sparse channel is a python-dict BM25
(`app/modules/retrieval/text_index.py:55-97`); it has no learned-sparse
option. BASELINE config 4 names "sparse BM25/SPLADE scores" — this module
is the SPLADE half of that disjunction.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.encoder import encode_hidden
from ..models.splade import (
    SpladeConfig,
    SpladeEncoder,
    apply_splade,
    sparsify_topk,
    splade_from_hidden,
)
from .bm25 import bm25_topk_sorted


@dataclass
class SpladeDeviceIndex:
    """Impact-sorted CSR postings over the hashed expansion vocabulary."""

    doc_ids: np.ndarray   # int32 [P] posting doc rows
    impacts: np.ndarray   # f32  [P] doc-side term weights
    row_ptr: np.ndarray   # int32 [V+1]
    n_docs: int

    @classmethod
    def from_expansions(cls, term_ids: np.ndarray, weights: np.ndarray,
                        vocab_size: int) -> "SpladeDeviceIndex":
        """Assemble CSR from per-doc sparse expansions ([N, K] ids with -1
        padding, [N, K] weights). Vectorized host pass; postings within a
        term sort by impact descending (ties by doc id for determinism)."""
        N, K = term_ids.shape
        flat_t = term_ids.reshape(-1)
        flat_w = weights.reshape(-1).astype(np.float32)
        flat_d = np.repeat(np.arange(N, dtype=np.int32), K)
        keep = (flat_t >= 0) & (flat_w > 0)
        flat_t, flat_w, flat_d = flat_t[keep], flat_w[keep], flat_d[keep]
        order = np.lexsort((flat_d, -flat_w, flat_t))
        flat_t, flat_w, flat_d = flat_t[order], flat_w[order], flat_d[order]
        counts = np.bincount(flat_t, minlength=vocab_size)
        row_ptr = np.zeros(vocab_size + 1, dtype=np.int32)
        np.cumsum(counts, out=row_ptr[1:])
        return cls(doc_ids=flat_d.astype(np.int32),
                   impacts=flat_w,
                   row_ptr=row_ptr,
                   n_docs=N)

    def save(self, path: str) -> None:
        np.savez(path, doc_ids=self.doc_ids, impacts=self.impacts,
                 row_ptr=self.row_ptr, n_docs=np.int64(self.n_docs))

    @classmethod
    def load(cls, path: str) -> "SpladeDeviceIndex":
        d = np.load(path)
        return cls(doc_ids=d["doc_ids"], impacts=d["impacts"],
                   row_ptr=d["row_ptr"], n_docs=int(d["n_docs"]))


def splade_engine_arrays(index: SpladeDeviceIndex, doc_top_terms: int):
    """Engine-shaped device dict for `QueryEngine`'s text channel
    (same keys as `Bm25DeviceIndex.device_arrays`): term-major CSR postings
    plus the doc-major padded layout the exact re-score phase gathers.

    The doc-major arrays invert the CSR: postings sorted by doc row (stable,
    so each doc's terms keep their term-id order); every doc holds at most
    ``doc_top_terms`` expansion terms by construction, so the fixed stride
    is exact (no truncation, unlike BM25's idf-ranked doc_major_padded cut).
    """
    n_docs = index.n_docs
    term_per_post = np.repeat(
        np.arange(len(index.row_ptr) - 1, dtype=np.int32),
        np.diff(index.row_ptr))
    order = np.argsort(index.doc_ids, kind="stable")
    d_s = np.asarray(index.doc_ids)[order]
    t_s = term_per_post[order]
    w_s = np.asarray(index.impacts, dtype=np.float32)[order]
    counts = np.bincount(d_s, minlength=n_docs)
    D = max(1, int(doc_top_terms))
    doc_terms = np.full((n_docs, D), -2, dtype=np.int32)
    doc_scores = np.zeros((n_docs, D), dtype=np.float32)
    starts = np.zeros(n_docs + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(d_s.shape[0], dtype=np.int64) - starts[d_s]
    keep = slot < D
    doc_terms[d_s[keep], slot[keep]] = t_s[keep]
    doc_scores[d_s[keep], slot[keep]] = w_s[keep]
    out = {
        "doc_ids": jnp.asarray(np.asarray(index.doc_ids, dtype=np.int32)),
        "scores": jnp.asarray(np.asarray(index.impacts, dtype=np.float32)),
        "row_ptr": jnp.asarray(np.asarray(index.row_ptr, dtype=np.int32)),
        "doc_terms_padded": jnp.asarray(doc_terms),
        "doc_scores_padded": jnp.asarray(doc_scores),
    }
    if index.doc_ids.size * 8 <= (256 << 20):
        out["posting_packed"] = jnp.asarray(np.stack(
            [np.asarray(index.doc_ids, dtype=np.int32),
             np.asarray(index.impacts, dtype=np.float32).view(np.int32)],
            axis=1))
    return out


class SpladeRetriever:
    """Standalone learned-sparse retriever: build + batched device query.

    Usage:
        enc = SpladeEncoder.load("splade.npz")   # or fresh for tests
        r = SpladeRetriever(enc)
        r.build(corpus_texts)                    # device-batched expansion
        ids, scores = r.query_batch(queries, top_k=10)
    """

    def __init__(self, encoder: SpladeEncoder, *,
                 term_topm: int = 256, build_batch: int = 512):
        self.encoder = encoder
        self.cfg: SpladeConfig = encoder.cfg
        self.term_topm = int(term_topm)
        self.build_batch = int(build_batch)
        self.index: Optional[SpladeDeviceIndex] = None
        self._dev = None       # (doc_ids, impacts, row_ptr) on device
        self._query_fn = {}    # (top_k, B) -> jitted program

    # ---- build ----

    def build(self, texts: Sequence[str]) -> SpladeDeviceIndex:
        """Expand the corpus in device batches (pad the tail to the batch
        shape so one compiled program serves every step)."""
        texts = list(texts)
        N, Bb = len(texts), self.build_batch
        K = self.cfg.doc_top_terms
        all_ids = np.full((N, K), -1, dtype=np.int32)
        all_w = np.zeros((N, K), dtype=np.float32)
        for start in range(0, N, Bb):
            chunk = texts[start:start + Bb]
            pad = Bb - len(chunk)
            ids, w = self.encoder.expand_texts(chunk + [""] * pad, k=K)
            all_ids[start:start + len(chunk)] = ids[: len(chunk)]
            all_w[start:start + len(chunk)] = w[: len(chunk)]
        self.set_index(SpladeDeviceIndex.from_expansions(
            all_ids, all_w, self.cfg.vocab_size))
        return self.index

    def set_index(self, index: SpladeDeviceIndex) -> None:
        self.index = index
        self._dev = (jnp.asarray(index.doc_ids), jnp.asarray(index.impacts),
                     jnp.asarray(index.row_ptr))
        self._query_fn = {}

    # ---- query ----

    def _make_query_fn(self, top_k: int):
        n_docs = self.index.n_docs
        topm = min(self.term_topm, n_docs)
        cfg = self.cfg

        def program(params, tok_ids, mask, doc_ids, impacts, row_ptr):
            w = apply_splade(params, tok_ids, mask, cfg)
            t_ids, t_w = sparsify_topk(w, cfg.query_top_terms)
            B, T = t_ids.shape
            scores, ids = bm25_topk_sorted(
                t_ids.reshape(B, 1, T), doc_ids, impacts, row_ptr,
                n_docs=n_docs, term_topm=topm, pool_k=top_k,
                term_weights=t_w.reshape(B, 1, T))
            return ids, scores

        return jax.jit(program)

    def query_batch(self, queries: Sequence[str], top_k: int = 10
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (doc ids [B, top_k] int32 with -1 padding, scores [B, top_k]).

        One device program per (top_k, batch-bucket) pair; the encoder and
        the posting scorer fuse into it."""
        if self.index is None:
            raise RuntimeError("SpladeRetriever.build() first")
        queries = list(queries)
        tok_ids, mask = self.encoder.host_featurize(queries)
        key = (top_k, len(queries))
        fn = self._query_fn.get(key)
        if fn is None:
            fn = self._query_fn[key] = self._make_query_fn(top_k)
        ids, scores = fn(self.encoder.params, jnp.asarray(tok_ids),
                         jnp.asarray(mask), *self._dev)
        return np.asarray(ids), np.asarray(scores)

    # ---- oracle (tests) ----

    def score_dense_oracle(self, queries: Sequence[str]) -> np.ndarray:
        """[B, N] exact scores via dense expansion vectors and the sparse
        doc matrix — the parity oracle for the CSR program (only docs'
        kept top-K terms participate, matching the index contents)."""
        if self.index is None:
            raise RuntimeError("SpladeRetriever.build() first")
        wq = self.encoder.dense_expand(list(queries))  # [B, V]
        t_ids, t_w = sparsify_topk(jnp.asarray(wq),
                                   self.cfg.query_top_terms)
        t_ids, t_w = np.asarray(t_ids), np.asarray(t_w)
        V, N = self.cfg.vocab_size, self.index.n_docs
        docs = np.zeros((N, V), dtype=np.float32)
        idx = self.index
        for t in range(V):
            for p in range(idx.row_ptr[t], idx.row_ptr[t + 1]):
                docs[idx.doc_ids[p], t] = idx.impacts[p]
        out = np.zeros((len(queries), N), dtype=np.float32)
        for b in range(len(queries)):
            for j, t in enumerate(t_ids[b]):
                if t >= 0:
                    out[b] += t_w[b, j] * docs[:, t]
        return out


class SpladeDenseHybrid:
    """BASELINE config 4 with the learned sparse channel: SPLADE posting
    scores select a candidate pool, dense cosine over the pool rows fuses
    in (min-max normalized, weighted sum), optionally followed by a
    cross-encoder rerank batch — all compute on device.

    The trunk runs ONCE per query batch: both the expansion head and the
    dense pooling head read the same `encode_hidden` states (the SPLADE
    param tree is a superset of the dense encoder's, so one tree powers
    both). Corpus side, `build` packs the impact CSR AND the corpus
    embedding matrix from the same trunk.
    """

    def __init__(self, encoder: SpladeEncoder, *,
                 alpha_sparse: float = 0.5, alpha_dense: float = 0.5,
                 pool_k: int = 100, term_topm: int = 256,
                 build_batch: int = 512, reranker=None,
                 rerank_top_m: int = 20):
        self.encoder = encoder
        self.cfg = encoder.cfg
        self.alpha_sparse = float(alpha_sparse)
        self.alpha_dense = float(alpha_dense)
        self.pool_k = int(pool_k)
        self.term_topm = int(term_topm)
        self.build_batch = int(build_batch)
        self.reranker = reranker  # models.cross_encoder.CrossEncoderReranker
        self.rerank_top_m = int(rerank_top_m)
        self.index: Optional[SpladeDeviceIndex] = None
        self.texts: List[str] = []
        self._dev = None
        self._emb = None  # [N, D] f32 L2-normalized corpus embeddings
        self._query_fn = {}

    def _embed_pool(self, h, mask):
        m = mask[:, :, None]
        pooled = jnp.sum(h * m, axis=1) / jnp.maximum(jnp.sum(m, axis=1),
                                                      1e-6)
        n = jnp.sqrt(jnp.sum(pooled * pooled, axis=-1, keepdims=True))
        return pooled / jnp.maximum(n, 1e-9)

    def build(self, texts: Sequence[str]) -> None:
        texts = list(texts)
        self.texts = texts
        N, Bb, K = len(texts), self.build_batch, self.cfg.doc_top_terms
        all_ids = np.full((N, K), -1, dtype=np.int32)
        all_w = np.zeros((N, K), dtype=np.float32)
        embs = np.zeros((N, self.cfg.encoder.d_model), dtype=np.float32)

        @jax.jit
        def expand_and_embed(params, ids, mask):
            h = encode_hidden(params, ids, mask, self.cfg.encoder)
            w = splade_from_hidden(params, h, mask, self.cfg, ids)
            t_ids, t_w = sparsify_topk(w, K)
            return t_ids, t_w, self._embed_pool(h, mask)

        for start in range(0, N, Bb):
            chunk = texts[start:start + Bb]
            pad = Bb - len(chunk)
            ids, mask = self.encoder.host_featurize(chunk + [""] * pad)
            t_ids, t_w, e = expand_and_embed(
                self.encoder.params, jnp.asarray(ids), jnp.asarray(mask))
            all_ids[start:start + len(chunk)] = np.asarray(t_ids)[: len(chunk)]
            all_w[start:start + len(chunk)] = np.asarray(t_w)[: len(chunk)]
            embs[start:start + len(chunk)] = np.asarray(e)[: len(chunk)]
        self.index = SpladeDeviceIndex.from_expansions(
            all_ids, all_w, self.cfg.vocab_size)
        self._dev = (jnp.asarray(self.index.doc_ids),
                     jnp.asarray(self.index.impacts),
                     jnp.asarray(self.index.row_ptr))
        self._emb = jnp.asarray(embs)
        self._query_fn = {}

    def _make_query_fn(self, top_k: int):
        n_docs = self.index.n_docs
        topm = min(self.term_topm, n_docs)
        P = min(self.pool_k, n_docs)
        cfg = self.cfg
        a_s, a_d = self.alpha_sparse, self.alpha_dense

        def minmax(x, valid):
            big = jnp.float32(1e30)
            mn = jnp.min(jnp.where(valid, x, big), axis=1, keepdims=True)
            mx = jnp.max(jnp.where(valid, x, -big), axis=1, keepdims=True)
            return jnp.where(valid, (x - mn) / jnp.maximum(mx - mn, 1e-9),
                             0.0)

        def program(params, tok_ids, mask, doc_ids, impacts, row_ptr, emb):
            h = encode_hidden(params, tok_ids, mask, cfg.encoder)
            w = splade_from_hidden(params, h, mask, cfg, tok_ids)
            t_ids, t_w = sparsify_topk(w, cfg.query_top_terms)
            B, T = t_ids.shape
            sp_s, sp_i = bm25_topk_sorted(
                t_ids.reshape(B, 1, T), doc_ids, impacts, row_ptr,
                n_docs=n_docs, term_topm=topm, pool_k=P,
                term_weights=t_w.reshape(B, 1, T))
            valid = sp_i >= 0
            q = self._embed_pool(h, mask)  # [B, D] normalized
            rows = jnp.where(valid, sp_i, 0)
            pool_e = jnp.take(emb, rows, axis=0)  # [B, P, D]
            cos = jnp.einsum("bd,bpd->bp", q, pool_e,
                             preferred_element_type=jnp.float32)
            fused = a_s * minmax(sp_s, valid) + a_d * minmax(cos, valid)
            fused = jnp.where(valid, fused, -jnp.inf)
            k = min(top_k, P)
            top_s, pos = jax.lax.top_k(fused, k)
            top_i = jnp.take_along_axis(sp_i, pos, axis=1)
            top_i = jnp.where(jnp.isfinite(top_s), top_i, -1)
            top_s = jnp.where(jnp.isfinite(top_s), top_s, 0.0)
            return top_i, top_s

        return jax.jit(program)

    def query_batch(self, queries: Sequence[str], top_k: int = 10
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (ids [B, top_k] int32, fused scores [B, top_k]); when a
        reranker is attached, the top `rerank_top_m` of each row are
        re-ordered by cross-encoder score (one [B*M, L] device batch)."""
        if self.index is None:
            raise RuntimeError("SpladeDenseHybrid.build() first")
        queries = list(queries)
        tok_ids, mask = self.encoder.host_featurize(queries)
        key = (top_k, len(queries))
        fn = self._query_fn.get(key)
        if fn is None:
            fn = self._query_fn[key] = self._make_query_fn(top_k)
        ids, scores = fn(self.encoder.params, jnp.asarray(tok_ids),
                         jnp.asarray(mask), *self._dev, self._emb)
        # np.array (copy): the rerank stage writes the top-m prefix in
        # place, and np.asarray of a device array is a read-only view
        ids, scores = np.array(ids), np.array(scores)
        if self.reranker is not None:
            m = min(self.rerank_top_m, ids.shape[1])
            cand_texts = [[self.texts[i] if i >= 0 else "" for i in row[:m]]
                          for row in ids]
            order = np.asarray(self.reranker.rerank_batch(queries,
                                                          cand_texts),
                               dtype=np.int64)
            ids[:, :m] = np.take_along_axis(ids[:, :m], order, axis=1)
            scores[:, :m] = np.take_along_axis(scores[:, :m], order, axis=1)
        return ids, scores
