"""BM25 scoring as a device program over CSR postings.

Replaces the reference's python dict-postings scorer
(text_index.py:55-97) with exact-math parity:

  idf(t)   = ln((N - df + 0.5) / (df + 0.5) + 1)
  s(t, d)  = idf(t) * tf * (k1 + 1) / (tf + k1 * (1 - b + b * dl/avgdl))
  score(q) = sum over q-term OCCURRENCES (duplicate query terms count twice,
             as in the reference's _score_doc loop over q_terms)
  multi-query merge: elementwise max or sum over per-query dense scores.

Layout: postings live in flat CSR arrays (`doc_ids [P]`, `tfs [P]`,
`row_ptr [V+1]`) resident in HBM. For each padded query term we
`dynamic_slice` a fixed-capacity window of its posting list, compute the
BM25 contribution vectorized, and scatter-add into a dense [N+1] score
vector (slot N swallows padding). Everything is static-shaped; the whole
multi-term, multi-query scorer jits into one program.

Capacity note: terms with df > max_postings_per_term are truncated to their
first `cap` postings. Such terms are near-stopwords whose idf ~ 0, so the
effect on top-k pools is negligible; raise `index.max_postings_per_term`
for exact parity on small corpora.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.hash_embed import tokenize


@dataclass
class Bm25DeviceIndex:
    """CSR postings + stats, as device-ready arrays.

    Attributes
    ----------
    doc_ids : int32 [P] flat posting doc indices
    tfs     : float32 [P] term frequencies
    row_ptr : int32 [V+1] CSR row pointers per term id
    df      : float32 [V] document frequency per term
    doc_lens: float32 [N] token count per doc
    vocab   : term -> term id
    k1, b   : BM25 parameters
    """

    doc_ids: np.ndarray
    tfs: np.ndarray
    row_ptr: np.ndarray
    df: np.ndarray
    doc_lens: np.ndarray
    vocab: Dict[str, int]
    k1: float = 1.5
    b: float = 0.75
    # Precomputed per-posting BM25 contribution c(t, d) — query-independent,
    # so it's baked at build time and query scoring is a pure gather+sum.
    # Postings within each term are sorted by contribution DESCENDING, so a
    # fixed-capacity window keeps each term's best-scoring docs.
    scores: Optional[np.ndarray] = None

    @property
    def n_docs(self) -> int:
        return int(self.doc_lens.shape[0])

    @property
    def avgdl(self) -> float:
        return float(self.doc_lens.mean()) if self.n_docs else 0.0

    # ---- construction ----

    @classmethod
    def build(cls, texts: Sequence[str], k1: float = 1.5, b: float = 0.75,
              use_native: bool = True,
              phrase_tokens: bool = False) -> "Bm25DeviceIndex":
        """Build from texts — native C++ streaming builder when available
        (bit-exact with the Python path, which remains the test oracle).

        ``phrase_tokens=True`` appends the multi-word capitalized-run
        pseudo-tokens (models/hash_embed.py phrase_augment) per document:
        inside the C++ tokenize loop on the native path, via a Python
        pre-pass on the fallback path — identical token streams."""
        if use_native:
            try:
                from ..native import bm25_build_native

                out = bm25_build_native(list(texts), k1=k1, b=b,
                                        phrase_tokens=phrase_tokens)
                if out is not None:
                    return cls(doc_ids=out["doc_ids"], tfs=out["tfs"],
                               row_ptr=out["row_ptr"], df=out["df"],
                               doc_lens=out["doc_lens"], vocab=out["vocab"],
                               k1=k1, b=b, scores=out["scores"])
            except ImportError:
                pass
        if phrase_tokens:
            from ..models.hash_embed import phrase_augment

            texts = [phrase_augment(t) for t in texts]
        return cls.build_python(texts, k1=k1, b=b)

    @classmethod
    def build_python(cls, texts: Sequence[str], k1: float = 1.5, b: float = 0.75) -> "Bm25DeviceIndex":
        vocab: Dict[str, int] = {}
        postings: List[Dict[int, int]] = []  # term id -> {doc: tf}
        doc_lens = np.zeros(len(texts), dtype=np.float32)
        for di, text in enumerate(texts):
            toks = tokenize(text)
            doc_lens[di] = len(toks)
            for t in toks:
                tid = vocab.setdefault(t, len(vocab))
                if tid == len(postings):
                    postings.append({})
                postings[tid][di] = postings[tid].get(di, 0) + 1
        V = len(vocab)
        df = np.array([len(p) for p in postings], dtype=np.float32)
        row_ptr = np.zeros(V + 1, dtype=np.int32)
        np.cumsum([len(p) for p in postings], out=row_ptr[1:])
        P = int(row_ptr[-1])
        doc_ids = np.zeros(P, dtype=np.int32)
        tfs = np.zeros(P, dtype=np.float32)
        n_total = float(len(texts))
        avgdl = float(doc_lens.mean()) if len(texts) else 1.0
        avgdl = avgdl or 1.0
        scores = np.zeros(P, dtype=np.float32)
        for tid, p in enumerate(postings):
            s = row_ptr[tid]
            idf = np.log((n_total - df[tid] + 0.5) / (df[tid] + 0.5) + 1.0)
            items = []
            for di, tf in p.items():
                dl = doc_lens[di]
                denom = tf + k1 * (1.0 - b + b * dl / avgdl)
                c = idf * tf * (k1 + 1.0) / (denom or 1.0)
                items.append((c, di, tf))
            # contribution-descending, doc-ascending tiebreak
            items.sort(key=lambda x: (-x[0], x[1]))
            for j, (c, di, tf) in enumerate(items):
                doc_ids[s + j] = di
                tfs[s + j] = tf
                scores[s + j] = c
        return cls(doc_ids=doc_ids, tfs=tfs, row_ptr=row_ptr, df=df,
                   doc_lens=doc_lens, vocab=vocab, k1=k1, b=b, scores=scores)

    # ---- query encoding (host) ----

    def encode_query_terms(self, queries: Sequence[str], max_terms: int) -> np.ndarray:
        """[Q, T] int32 term ids per query occurrence, -1 padded.

        Keeps duplicate occurrences (reference scores each occurrence)."""
        out = np.full((len(queries), max_terms), -1, dtype=np.int32)
        for qi, q in enumerate(queries):
            tids = [self.vocab[t] for t in tokenize(q) if t in self.vocab]
            tids = tids[:max_terms]
            out[qi, : len(tids)] = tids
        return out

    def ensure_scores(self) -> np.ndarray:
        """(Re)compute precomputed contributions for indexes loaded without
        them; postings order is preserved (whatever order they were saved)."""
        if self.scores is not None:
            return self.scores
        n_total = float(self.n_docs)
        avgdl = self.avgdl or 1.0
        idf = np.log((n_total - self.df + 0.5) / (self.df + 0.5) + 1.0)
        term_of_posting = np.repeat(
            np.arange(len(self.df), dtype=np.int64),
            np.diff(self.row_ptr).astype(np.int64),
        )
        tf = np.asarray(self.tfs, dtype=np.float32)
        dl = np.asarray(self.doc_lens)[np.asarray(self.doc_ids)]
        denom = tf + self.k1 * (1.0 - self.b + self.b * dl / avgdl)
        self.scores = (idf[term_of_posting] * tf * (self.k1 + 1.0) /
                       np.where(denom > 0, denom, 1.0)).astype(np.float32)
        return self.scores

    def doc_major(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Doc-major CSR view: (doc_terms [P], doc_scores [P], doc_ptr [N+1]).

        The transpose of the term-major postings, used for exact pool
        re-scoring (`bm25_rescore_pool`). Derived once and cached."""
        if getattr(self, "_doc_major", None) is not None:
            return self._doc_major
        scores = self.ensure_scores()
        V = len(self.df)
        term_of_posting = np.repeat(
            np.arange(V, dtype=np.int32), np.diff(self.row_ptr).astype(np.int64)
        )
        doc_arr = np.asarray(self.doc_ids)
        order = np.argsort(doc_arr, kind="stable")
        doc_terms = term_of_posting[order]
        doc_scores = np.asarray(scores)[order]
        counts = np.bincount(doc_arr, minlength=self.n_docs)
        doc_ptr = np.zeros(self.n_docs + 1, dtype=np.int32)
        np.cumsum(counts, out=doc_ptr[1:])
        self._doc_major = (doc_terms.astype(np.int32), doc_scores.astype(np.float32), doc_ptr)
        return self._doc_major

    def doc_major_padded(self, doc_cap: int = 64) -> Tuple[np.ndarray, np.ndarray]:
        """Fixed-stride doc-major view: (terms [N, D] int32 -2-padded,
        scores [N, D] f32). Row gathers on this layout are contiguous,
        unlike per-doc dynamic slices. Docs with more than
        ``doc_cap`` distinct terms keep their HIGHEST-contribution terms."""
        key = ("_doc_major_padded", doc_cap)
        cached = getattr(self, "_dmp_cache", None)
        if cached and cached[0] == doc_cap:
            return cached[1], cached[2]
        doc_terms, doc_scores, doc_ptr = self.doc_major()
        N = self.n_docs
        terms = np.full((N, doc_cap), -2, dtype=np.int32)
        scores = np.zeros((N, doc_cap), dtype=np.float32)
        for d in range(N):
            s, e = int(doc_ptr[d]), int(doc_ptr[d + 1])
            length = e - s
            if length <= doc_cap:
                terms[d, :length] = doc_terms[s:e]
                scores[d, :length] = doc_scores[s:e]
            else:
                order = np.argsort(-doc_scores[s:e], kind="stable")[:doc_cap]
                terms[d] = doc_terms[s:e][order]
                scores[d] = doc_scores[s:e][order]
        self._dmp_cache = (doc_cap, terms, scores)
        return terms, scores

    def device_arrays(self, doc_cap: int = 64, *,
                      packed_postings: Optional[bool] = None,
                      ) -> Dict[str, jnp.ndarray]:
        dmp_terms, dmp_scores = self.doc_major_padded(doc_cap)
        out = {
            "doc_ids": jnp.asarray(self.doc_ids),
            "tfs": jnp.asarray(self.tfs),
            "row_ptr": jnp.asarray(self.row_ptr),
            "df": jnp.asarray(self.df),
            "doc_lens": jnp.asarray(self.doc_lens),
            "scores": jnp.asarray(self.ensure_scores()),
            "doc_terms_padded": jnp.asarray(dmp_terms),
            "doc_scores_padded": jnp.asarray(dmp_scores),
        }
        # interleaved (doc_id, bitcast(score)) pairs so phase-1's posting
        # window gather is ONE take of 8-byte rows instead of two 4-byte
        # gathers. Derived at load, not part of the disk format;
        # auto-skip above 256MB of postings (the duplicate would cost
        # ~1.6GB of device memory at fullwiki scale).
        if packed_postings is None:
            packed_postings = self.doc_ids.size * 8 <= (256 << 20)
        if packed_postings:
            out["posting_packed"] = jnp.asarray(np.stack(
                [np.asarray(self.doc_ids, dtype=np.int32),
                 np.asarray(self.ensure_scores()).view(np.int32)], axis=1))
        return out


@functools.partial(jax.jit, static_argnames=("n_docs", "term_topm", "pool_k"))
def bm25_topk_sorted(
    term_ids: jax.Array,  # [B, E, T] int32, -1 padded
    doc_ids: jax.Array,  # [P] int32 (contribution-sorted within each term)
    contribs: jax.Array,  # [P] f32
    row_ptr: jax.Array,  # [V+1] int32
    *,
    n_docs: int,
    term_topm: int = 64,
    pool_k: int = 200,
    posting_packed: Optional[jax.Array] = None,  # [P, 2] (id, bitcast score)
    term_weights: Optional[jax.Array] = None,  # [B, E, T] f32 >= 0
) -> Tuple[jax.Array, jax.Array]:
    """Scatter-free BM25 pool selection: (pool scores [B,K], pool ids [B,K]).

    The scatter-free path (the scatter formulation is the parity
    oracle): gather each query-term occurrence's top-``term_topm``
    postings (they're stored contribution-descending), concatenate a
    query's E*T windows, SORT by doc id, sum equal-id runs with T shifted
    adds (elementwise ops), and take the top ``pool_k`` run totals. Variants are max-merged by a second sort over (doc,
    -variant_score) ... here simplified: variants concatenate and the merge
    uses per-variant sums followed by a cross-variant max on the shared
    sorted axis.

    Exactness: identical to the reference BM25 for every document that
    appears in at least one matched term's top-``term_topm`` postings; only
    near-zero-idf stopword tails are truncated (same contract as the
    capacity window of `bm25_scores_batched`).

    Padding ids are ``n_docs`` and sort to the end with zero contribution.

    ``term_weights`` (optional) scales each query term occurrence's gathered
    contributions — the learned-sparse (SPLADE) scorer rides this seam:
    score(q, d) = sum_t w_q(t) * impact(t, d) with the posting arrays
    holding doc-side impacts. Weights must be >= 0 (a zero total marks an
    empty slot). None = BM25 behavior.
    """
    v_s, v_docs = bm25_variant_pools(
        term_ids, doc_ids, contribs, row_ptr, n_docs=n_docs,
        term_topm=term_topm, pool_k=pool_k, posting_packed=posting_packed,
        term_weights=term_weights)
    return merge_variant_pools(v_s, v_docs, n_docs=n_docs, pool_k=pool_k)


def bm25_variant_pools(
    term_ids: jax.Array,
    doc_ids: jax.Array,
    contribs: jax.Array,
    row_ptr: jax.Array,
    *,
    n_docs: int,
    term_topm: int,
    pool_k: int,
    posting_packed: Optional[jax.Array] = None,
    term_weights: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array]:
    """First half of `bm25_topk_sorted`: each query variant's own top
    ``min(pool_k, T * term_topm)`` docs by window total -> (scores, ids),
    both [B, E, K], ordered (score desc, id asc); empty slots hold score 0
    and id ``n_docs``."""
    B, E, T = term_ids.shape
    N = n_docs
    m = term_topm

    flat_t = term_ids.reshape(-1)
    valid = flat_t >= 0
    t_safe = jnp.maximum(flat_t, 0)
    starts = row_ptr[t_safe]
    lengths = jnp.minimum(row_ptr[t_safe + 1] - starts, m)

    # flat gather at starts+iota: vmap(dynamic_slice) lowers to per-window
    # slices instead of one big gather
    j = jnp.arange(m, dtype=jnp.int32)[None, :]
    win_idx = starts[:, None] + j
    in_range = (j < lengths[:, None]) & valid[:, None]
    if posting_packed is not None:
        # one gather of interleaved 8-byte (id, score) rows — the gather is
        # per-element-overhead-bound, so halving the element count beats
        # two separate 4-byte takes
        pad = jnp.broadcast_to(
            jnp.asarray([N, 0], dtype=jnp.int32)[None, :], (m, 2))
        packed_p = jnp.concatenate([posting_packed, pad])
        rows = jnp.take(packed_p, win_idx.reshape(-1), axis=0)
        docs_w = rows[:, 0].reshape(win_idx.shape)
        c_w = jax.lax.bitcast_convert_type(
            rows[:, 1], jnp.float32).reshape(win_idx.shape)
    else:
        doc_ids_p = jnp.concatenate(
            [doc_ids, jnp.full((m,), N, dtype=jnp.int32)])
        contribs_p = jnp.concatenate(
            [contribs, jnp.zeros((m,), dtype=jnp.float32)])
        docs_w = jnp.take(doc_ids_p, win_idx)  # [B*E*T, m]
        c_w = jnp.take(contribs_p, win_idx)
    docs_w = jnp.where(in_range, docs_w, N)
    c_w = jnp.where(in_range, c_w, 0.0)
    if term_weights is not None:
        c_w = c_w * term_weights.reshape(-1)[:, None]

    W = T * m
    docs_q = docs_w.reshape(B * E, W)
    c_q = c_w.reshape(B * E, W)

    # sort by doc id; aggregate equal runs. One variadic sort carrying the
    # contributions as payload, instead of argsort + 2 row-gathers. The
    # sort is stable, so a run keeps its query-term slot order.
    docs_s, c_s = jax.lax.sort((docs_q, c_q), dimension=1, num_keys=1,
                               is_stable=True)

    # run totals: a doc occurs at most once per term window, so its run is
    # at most T long, and the total at the run's last entry is the sum of
    # the T entries ending there that share its id, added in slot order
    # from zero — the order `bm25_rescore_pool` adds them in. The totals
    # are thus bit-identical to the exact re-score wherever the windows
    # hold all of a doc's terms, and independent of the rest of the row
    # (a prefix-sum difference would round by the row's other docs, so a
    # shard's row and the whole corpus's would select different pools).
    run_total = jnp.zeros_like(c_s)
    for j in range(T - 1, -1, -1):
        d_j = jnp.pad(docs_s[:, :W - j], ((0, 0), (j, 0)),
                      constant_values=-1)
        c_j = jnp.pad(c_s[:, :W - j], ((0, 0), (j, 0)))
        run_total = run_total + jnp.where(d_j == docs_s, c_j, 0.0)
    is_run_end = jnp.concatenate(
        [docs_s[:, 1:] != docs_s[:, :-1], jnp.ones((B * E, 1), dtype=jnp.bool_)],
        axis=1,
    )
    score_at = jnp.where(is_run_end & (docs_s < N), run_total, 0.0)

    # per-variant top pool; ties keep the lower doc id (rows are id-sorted)
    K = min(pool_k, W)
    v_s, v_pos = jax.lax.top_k(score_at, K)
    v_docs = jnp.take_along_axis(docs_s, v_pos, axis=1)
    v_docs = jnp.where(v_s > 0, v_docs, N)
    return v_s.reshape(B, E, K), v_docs.reshape(B, E, K)


def merge_variant_pools(v_s: jax.Array, v_docs: jax.Array, *, n_docs: int,
                        pool_k: int) -> Tuple[jax.Array, jax.Array]:
    """Second half of `bm25_topk_sorted`: max-merge the variants' pools
    ([B, E, K] from `bm25_variant_pools`) by doc id (a sort + segment-max
    over the E*K union) and keep the top ``pool_k`` -> (scores, ids),
    ids -1 where the score is 0."""
    B, E, K = v_s.shape
    N = n_docs
    u_docs = v_docs.reshape(B, E * K)
    u_s = v_s.reshape(B, E * K)
    if E > 1:
        # max-merge variants: sort the E*K union by doc id; a doc appears at
        # most E times (contiguously), so its run max is the max over the
        # E-1 preceding lanes with the same id, read at the run's last entry
        # (variadic sort: run-internal order is irrelevant under max)
        d2, s2 = jax.lax.sort((u_docs, u_s), dimension=1, num_keys=1)
        idx2 = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 1)
        merged = s2
        for shift in range(1, E):
            same = jnp.take_along_axis(
                d2, jnp.maximum(idx2 - shift, 0), axis=1
            ) == d2
            prev = jnp.take_along_axis(s2, jnp.maximum(idx2 - shift, 0), axis=1)
            merged = jnp.maximum(
                merged, jnp.where(same & (idx2 >= shift), prev, -jnp.inf)
            )
        end2 = jnp.concatenate(
            [d2[:, 1:] != d2[:, :-1], jnp.ones((B, 1), dtype=jnp.bool_)], axis=1
        )
        final_s = jnp.where(end2 & (d2 < N), merged, 0.0)
        top_s, pos = jax.lax.top_k(final_s, min(pool_k, final_s.shape[1]))
        top_d = jnp.take_along_axis(d2, pos, axis=1)
    else:
        top_s, pos = jax.lax.top_k(u_s, min(pool_k, u_s.shape[1]))
        top_d = jnp.take_along_axis(u_docs, pos, axis=1)

    top_d = jnp.where(top_s > 0, top_d, -1)
    return top_s, top_d


def canonical_pool_order(pool_s: jax.Array, pool_i: jax.Array
                         ) -> Tuple[jax.Array, jax.Array]:
    """Order a candidate pool by (score desc, id asc), invalid entries
    (score <= 0 or id < 0) last. Phase-1 leaves the pool in the order of
    its own float sums, whose rounding depends on how many candidates a
    row holds; downstream selections that break ties by position (the
    graph seeds) must not inherit that, or a row-sharded pool and the
    one-device pool would seed differently at exact score ties."""
    valid = (pool_s > 0) & (pool_i >= 0)
    k1 = jnp.where(valid, -pool_s, jnp.inf)
    k2 = jnp.where(valid, pool_i, jnp.iinfo(jnp.int32).max)
    _, _, pool_s, pool_i = jax.lax.sort((k1, k2, pool_s, pool_i),
                                        dimension=1, num_keys=2)
    return pool_s, pool_i


def bm25_rescore_pool(
    pool_i: jax.Array,  # [B, K] int32 candidate doc rows, -1 padded
    term_ids: jax.Array,  # [B, E, T] int32 query term occurrences, -1 padded
    doc_terms_padded: jax.Array,  # [N, D] int32 doc-major term ids, -2 padded
    doc_scores_padded: jax.Array,  # [N, D] f32 doc-major contributions
    *,
    n_docs: int,
    term_weights: Optional[jax.Array] = None,  # [B, E, T] f32 >= 0
) -> jax.Array:
    """EXACT BM25 scores [B, K] for the candidate pool (max over variants).

    Phase 2 of the scatter-free design: gather each candidate doc's
    fixed-stride term row (one contiguous row gather instead of per-doc
    dynamic slices) and sum the contributions of terms that occur in
    the query — each query-term OCCURRENCE counts (duplicate terms score
    twice, reference _score_doc semantics). Pure vectorized compares, no
    scatter, no [N]-sized buffers.

    Exact for docs whose distinct-term count fits the padded stride; longer
    docs keep their highest-contribution terms (see doc_major_padded).
    """
    B, K = pool_i.shape
    N = n_docs

    flat = pool_i.reshape(-1)
    safe = jnp.where(flat >= 0, flat, 0)
    wt = jnp.take(doc_terms_padded, safe, axis=0)  # [B*K, D]
    wc = jnp.take(doc_scores_padded, safe, axis=0)
    wt = jnp.where((flat >= 0)[:, None], wt, -2)
    wc = jnp.where((flat >= 0)[:, None], wc, 0.0)

    D = wt.shape[1]
    wt_b = wt.reshape(B, K, D)
    wc_b = wc.reshape(B, K, D)
    T = term_ids.shape[2]

    # loop over the T query-term slots with a [B, E, K] accumulator: each
    # step is a small [B, E, K, D] compare + masked reduce, which XLA fuses;
    # the single-shot [B,K,D,E,T] broadcast materialized >100MB and dominated
    # the engine.
    def body(t, acc):
        tid_t = jax.lax.dynamic_index_in_dim(term_ids, t, axis=2,
                                             keepdims=False)  # [B, E]
        m = (wt_b[:, None, :, :] == tid_t[:, :, None, None]) & (
            tid_t >= 0
        )[:, :, None, None]
        contrib = jnp.sum(jnp.where(m, wc_b[:, None, :, :], 0.0), axis=-1)
        if term_weights is not None:
            # learned-sparse seam (same contract as bm25_topk_sorted):
            # score(q, d) = sum_t w_q(t) * impact(t, d)
            w_t = jax.lax.dynamic_index_in_dim(term_weights, t, axis=2,
                                               keepdims=False)  # [B, E]
            contrib = contrib * w_t[:, :, None]
        return acc + contrib

    E = term_ids.shape[1]
    per_variant = jax.lax.fori_loop(
        0, T, body, jnp.zeros((B, E, K), dtype=jnp.float32)
    )  # [B, E, K]
    return jnp.max(per_variant, axis=1)


@functools.partial(jax.jit, static_argnames=("n_docs", "cap", "merge"))
def bm25_scores_batched(
    term_ids: jax.Array,  # [B, E, T] int32, -1 padded (E query variants)
    doc_ids: jax.Array,  # [P] int32
    contribs: jax.Array,  # [P] f32 precomputed c(t, d)
    row_ptr: jax.Array,  # [V+1] int32
    *,
    n_docs: int,
    cap: int,
    merge: str = "max",
) -> jax.Array:
    """Batched BM25: gather each term's top-``cap`` precomputed contributions
    and land the whole batch with ONE scatter-add into [B*E, N+1].

    This is the engine's production path: ~30x faster than per-term scatters
    because XLA sees one large scatter instead of B*E*T small ones, and the
    per-posting arithmetic happened at index build. Postings are stored
    contribution-descending, so the cap window keeps each term's strongest
    docs (truncation only sheds near-zero stopword tails).

    Returns merged [B, N] (max/sum over the E variants).
    """
    B, E, T = term_ids.shape
    N = n_docs
    P = doc_ids.shape[0]
    doc_ids_p = jnp.concatenate([doc_ids, jnp.full((cap,), N, dtype=jnp.int32)])
    contribs_p = jnp.concatenate([contribs, jnp.zeros((cap,), dtype=jnp.float32)])

    flat_t = term_ids.reshape(-1)  # [B*E*T]
    valid = flat_t >= 0
    t_safe = jnp.maximum(flat_t, 0)
    starts = row_ptr[t_safe]
    lengths = jnp.minimum(row_ptr[t_safe + 1] - starts, cap)

    def window(start):
        return (
            jax.lax.dynamic_slice(doc_ids_p, (start,), (cap,)),
            jax.lax.dynamic_slice(contribs_p, (start,), (cap,)),
        )

    docs_w, c_w = jax.vmap(window)(starts)  # [BET, cap]
    j = jnp.arange(cap, dtype=jnp.int32)[None, :]
    in_range = (j < lengths[:, None]) & valid[:, None]
    docs_w = jnp.where(in_range, docs_w, N)
    c_w = jnp.where(in_range, c_w, 0.0)

    variant = (
        jnp.arange(B * E * T, dtype=jnp.int32)[:, None] // T
    )  # [BET, 1] -> broadcast over cap
    variant = jnp.broadcast_to(variant, (B * E * T, cap))

    acc = (
        jnp.zeros((B * E, N + 1), dtype=jnp.float32)
        .at[variant.reshape(-1), docs_w.reshape(-1)]
        .add(c_w.reshape(-1))
    )
    per_variant = acc[:, :N].reshape(B, E, N)
    if merge == "sum":
        return jnp.sum(per_variant, axis=1)
    return jnp.max(per_variant, axis=1)


@functools.partial(jax.jit, static_argnames=("n_docs", "cap", "merge", "k1", "b"))
def bm25_scores(
    term_ids: jax.Array,  # [Q, T] int32, -1 padded
    doc_ids: jax.Array,  # [P] int32
    tfs: jax.Array,  # [P] f32
    row_ptr: jax.Array,  # [V+1] int32
    df: jax.Array,  # [V] f32
    doc_lens: jax.Array,  # [N] f32
    *,
    n_docs: int,
    cap: int = 4096,
    merge: str = "max",
    k1: float = 1.5,
    b: float = 0.75,
) -> jax.Array:
    """Dense BM25 scores [Q or 1, N] f32 (merged over queries if requested).

    Returns merged [N] when ``merge`` in ("max", "sum"), else per-query [Q, N].
    """
    N = n_docs
    n_total = jnp.float32(N)
    avgdl = jnp.mean(doc_lens)
    avgdl = jnp.where(avgdl > 0, avgdl, 1.0)
    # Pad postings arrays so a cap-window slice never reads OOB.
    P = doc_ids.shape[0]
    doc_ids_p = jnp.concatenate([doc_ids, jnp.full((cap,), N, dtype=jnp.int32)])
    tfs_p = jnp.concatenate([tfs, jnp.zeros((cap,), dtype=jnp.float32)])

    def score_one_term(tid: jax.Array) -> jax.Array:
        """Dense [N+1] contribution of one query-term occurrence."""
        valid_term = tid >= 0
        t = jnp.maximum(tid, 0)
        start = row_ptr[t]
        length = row_ptr[t + 1] - start
        length = jnp.minimum(length, cap)
        docs = jax.lax.dynamic_slice(doc_ids_p, (start,), (cap,))
        f = jax.lax.dynamic_slice(tfs_p, (start,), (cap,))
        j = jnp.arange(cap, dtype=jnp.int32)
        in_range = (j < length) & valid_term
        docs = jnp.where(in_range, docs, N)  # dump slot
        dl = doc_lens[jnp.minimum(docs, N - 1)]
        n_t = df[t]
        idf = jnp.log((n_total - n_t + 0.5) / (n_t + 0.5) + 1.0)
        denom = f + k1 * (1.0 - b + b * dl / avgdl)
        contrib = idf * f * (k1 + 1.0) / jnp.where(denom > 0, denom, 1.0)
        contrib = jnp.where(in_range, contrib, 0.0)
        dense = jnp.zeros((N + 1,), dtype=jnp.float32).at[docs].add(contrib)
        return dense

    def score_one_query(tids: jax.Array) -> jax.Array:
        per_term = jax.lax.map(score_one_term, tids)  # [T, N+1]
        return jnp.sum(per_term, axis=0)[:N]

    per_query = jax.vmap(score_one_query)(term_ids)  # [Q, N]
    if merge == "max":
        return jnp.max(per_query, axis=0)
    if merge == "sum":
        return jnp.sum(per_query, axis=0)
    return per_query
