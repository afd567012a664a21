"""QueryEngine — the device-resident hybrid index-and-query engine.

This is the device program that replaces the reference's entire hybrid
retrieval stack (retrieval_backend.py:303-385 steps 2-5): BM25 scoring,
graph-neighborhood expansion, dense scoring of the BM25 pool, per-channel
min-max normalization, alpha-weighted fusion, and final top-k — one jitted
computation per query batch. The host supplies tokenized queries and gets
back ``(ids: int32[B, K], scores: f32[B, K])`` plus per-channel normalized
scores for hit metadata; no per-candidate python ever runs.

Pool semantics parity (the order-sensitive part — SURVEY.md §7 risk 3):
  - text channel pool  = top ``pool_k`` BM25 candidates with score > 0
    (BM25LiteIndex.search returns positive-score candidates only);
  - dense channel pool = the text pool (DenseReranker scores BM25
    candidates only, retrieval_backend.py:215-247);
  - graph channel pool = top ``pool_k`` frontier-expansion scores > 0;
  - min-max normalization is per-channel over its own pool;
  - fused score = a_text*text + a_graph*graph + a_dense*dense over the
    union, absent channels contributing 0.

Graph seeds: explicit row lists (mapped from a per-question graph's q_match
edges — parity mode), or derived in-program from the strongest BM25 pool
entries with seed-strength-weighted propagation (corpus-scale mode).

Execution design (see docs/DESIGN.md): everything is gathers, sorts and
matmuls; no scatters or [B, N] channel buffers on the default path. BM25 =
sort-aggregate pool selection + exact doc-major re-score; graph expansion =
gather-max over the symmetric adjacency; fusion = sort-dedup over the
2*pool_k candidate union. Query embedding is fused into the same program
and outputs are packed into two arrays, so one batch is one dispatch and
two device->host copies.
"""
from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.dto import HitBatch
from ..index.packed import PackedIndex
from ..models.hash_embed import phrase_augment, HashEmbedEncoder, tokenize
from ..utils.textspan import capitalized_runs
from ..ops.bm25 import (bm25_rescore_pool, bm25_scores_batched,
                        bm25_topk_sorted, canonical_pool_order)
from ..ops.fusion import fuse_channels, fuse_pools_compact, reorder_hits
from ..ops.graph import (expand_frontier, expand_frontier_weighted,
                         expand_frontier_weighted_batched,
                         expand_frontier_weighted_capped,
                         expand_frontier_weighted_compact)
from ..telemetry.sinks import TelemetrySink, record_device_timing

# The dense channel's dot products: float32 at HIGHEST, so that a GPU does
# not round the operands to TF32 (10-bit mantissas) and the scores agree
# with the host reference to float32 rounding. The pool einsum is a
# batched matrix-vector product, bound by memory, not by the multiply.
DENSE_PRECISION = jax.lax.Precision.HIGHEST


@dataclass
class EngineConfig:
    top_k: int = 30
    pool_k: int = 200
    qe_variants: int = 4  # 1 original + up to 3 expansions
    max_query_terms: int = 32
    max_seed_rows: int = 64
    bm25_posting_cap: int = 4096  # scatter path capacity (parity oracle)
    bm25_impl: str = "sorted"  # "sorted" (scatter-free, fast) | "scatter"
    bm25_term_topm: int = 128  # sorted path: postings window per term occurrence
    bm25_doc_cap: int = 64  # sorted path: doc-major window for exact re-score
    fusion_impl: str = "compact"  # "compact" (pool union, no [B,N]) | "dense"
    graph_window: int = 1
    # iterative 2-hop mode: graph window for the HOP-2 program only
    # (None = same as the hop's graph_window argument). Hop-2 queries
    # already name the bridge entity, so BM25/dense land directly in the
    # bridge doc and the wave only needs doc-adjacency (window 1), not the
    # cross-doc 2-hop expansion hop-1 needs — at scale the second wave is
    # a large share of the program (multihop._prep_and_dispatch_hop2).
    hop2_graph_window: Optional[int] = None
    # iterative 2-hop mode: bridge-entity budget for the HOP-2 query
    # construction (None = multihop's default of 4 bridges / 3 query
    # variants). Hop-2 dispatches 1 query + (bridges-1) expansion
    # variants, and the variant bucket E pads to a power of two — the
    # default's 3 variants run the hop-2 BM25 phase at E=4, 4x hop-1's
    # sort width with one row always empty. 2 bridges -> E=2 halves the
    # hop-2 text-channel work; recall impact is corpus-dependent.
    hop2_max_bridges: Optional[int] = None
    # iterative 2-hop mode: candidate-pool width for the HOP-2 program
    # only (None = cfg.pool_k). Hop-2 queries name the bridge title, so
    # the gold doc sits at the head of the BM25 pool and a narrower pool
    # trims every pool-width stage of the hop-2 program at no recall.
    hop2_pool_k: Optional[int] = None
    include_entity_graph: bool = True
    alpha_text: float = 0.4
    alpha_graph: float = 0.2
    alpha_dense: float = 0.4
    # two-stage fusion: when set, the final top-k MEMBERSHIP is selected
    # by the alphas above, then the k hits are re-RANKED by this second
    # (text, graph, dense) weighting over the same channel norms, and the
    # reported hit score becomes the ordering score. Round-3 anatomy:
    # selection 0.15/0.70/0.15 + ordering 0.4/0.2/0.4 gives the graph-
    # heavy weights' recall@10 (0.99 at scale vs 0.5) AND the parity
    # weights' MRR on every measured corpus family (docs/ROUND3.md).
    # None = single-stage fusion (reference parity).
    order_alphas: Optional[Tuple[float, float, float]] = None
    # auto-seed mode: propagate BM25 seed strength (max * decay) instead of
    # uniform decay — uninformative with ~64 equal seeds otherwise
    graph_seed_weighted: bool = True
    batch_buckets: Tuple[int, ...] = (1, 8, 64, 256)
    frontier_cap: Optional[int] = None
    # graph channel formulation:
    #   "dense"   — [B, N] wave buffers (exact, right at small N)
    #   "compact" — N-independent sort-aggregate frontier
    #               (ops.graph.expand_frontier_weighted_compact): the wave is
    #               a (ids, vals) pair of width graph_compact_cap; cost no
    #               longer scales with the corpus, unlocking large batches at
    #               1M+ rows. Exact while each hop's live frontier fits the
    #               cap (else weakest-node truncation, same as frontier_cap).
    #   "auto"    — compact when the [B, N] buffers exceed ~256MB and fusion
    #               is pool-compact; dense otherwise
    graph_impl: str = "auto"
    # hop-2 sort width is cap*deg
    graph_compact_cap: int = 256
    # dense-path wave precision: "bfloat16" (the shipped default, matching
    # config/settings.json) halves the expansion's HBM traffic — the
    # dominant stage of the dense graph formulation — at identical measured
    # recall. Bit-exact float-oracle runs (e.g. NumPy parity tests) must
    # set "float32": bf16 rounds hop decays and can flip near-tie graph
    # rankings. The sharded engine applies the same dtype, so sharded ==
    # single-chip bit-for-bit under either setting.
    graph_wave_dtype: str = "bfloat16"
    # graph pool selection uses lax.approx_max_k at
    # n > graph_pool_approx_from rows. On the GPU and the CPU XLA lowers
    # approx_max_k to its exact sort fallback, so both branches return
    # the exact pool. Set graph_pool_exact=True to force lax.top_k — the
    # sharded engine is always exact.
    graph_pool_approx_from: int = 4096
    graph_pool_exact: bool = False
    # dense-channel formulation:
    #   "pool"   — gather the pool rows' embeddings ([B, K, d]) and dot
    #              with the query: N-independent, the only option at scale
    #   "matmul" — one matmul Q @ Eᵀ ([B, N] scores) + a scalar
    #              take_along_axis at the pool ids, in place of the
    #              [B, K, d] row gather; requires the [B, N] buffer.
    #   "auto"   — currently "pool": the matmul's f32 accumulation order
    #              differs from the gather-einsum's, flipping near-tie
    #              rankings, so it would break the bit-for-bit agreement
    #              promised across engine formulations (dense/compact
    #              graph, sharded/single-chip). Opt in per engine where
    #              throughput matters more than cross-formulation
    #              bit-parity (bench.py's headline engine does).
    dense_impl: str = "auto"
    # idf-guided query pruning: drop query tokens whose document frequency
    # exceeds this fraction of the corpus before encoding (0 = off, the
    # reference-parity behavior). High-df tokens contribute ~nothing to
    # BM25 yet flood the candidate pool and the graph seeds with template
    # matches; pruning them nearly doubled Recall@10 on the adversarial
    # synthetic corpus (0.465 -> 0.887 at ratio 0.05) because the seeds
    # then concentrate on discriminative entities and the entity-link
    # graph channel reaches the hop-2 evidence.
    query_df_ratio_max: float = 0.0
    # text-channel implementation (BASELINE config 4 "BM25/SPLADE"):
    #   "bm25"   — reference-parity lexical postings (the default)
    #   "splade" — learned-sparse: the corpus postings are SPLADE doc
    #              expansions (ops.splade.SpladeDeviceIndex) and the query
    #              term ids/weights come from the expansion head INSIDE the
    #              device program (one trunk run per batch; rides the
    #              term_weights seam of bm25_topk_sorted/bm25_rescore_pool).
    #              Requires splade_weights; graph + dense channels are
    #              unchanged. idf query pruning is disabled (the expansion
    #              head owns term weighting), bm25_impl must stay "sorted".
    sparse_impl: str = "bm25"
    splade_weights: str = ""  # SpladeEncoder checkpoint path

    def __post_init__(self):
        if self.order_alphas is not None:
            oa = tuple(float(a) for a in self.order_alphas)
            if len(oa) != 3:
                # fail at construction with the config key's name, not at
                # first query inside jit with an opaque einsum shape error
                raise ValueError(
                    f"order_alphas must be 3 weights (text, graph, dense), "
                    f"got {self.order_alphas!r}")
            object.__setattr__(self, "order_alphas", oa)


@dataclass
class QueryResult:
    """Host-side view of one query batch's output."""

    hits: HitBatch
    channel_norms: np.ndarray  # [C=3, B, K] normalized channel scores at hits
    diagnostics: Dict[str, Any] = field(default_factory=dict)


class PendingQuery:
    """In-flight query batch: the device program has been dispatched (JAX
    dispatch is async) but the outputs are not fetched yet. ``result()``
    blocks on the transfer and unpacks. Enables pipelining: prep/dispatch
    batch i+1 while batch i executes (`query_batches_pipelined`)."""

    def __init__(self, *, engine=None, f32_pack=None, i32_pack=None,
                 B: int = 0, B_real: int = 0, k: int = 0, pool_k: int = 0,
                 window: int = 0, t0: float = 0.0, trace_id: str = "",
                 done: Optional[QueryResult] = None):
        self._engine = engine
        self._f32 = f32_pack
        self._i32 = i32_pack
        self._B, self._B_real, self._k = B, B_real, k
        self._pool_k, self._window = pool_k, window
        self._t0, self._trace_id = t0, trace_id
        self._done = done
        # start the device->host copy NOW: the transfer queues behind the
        # just-dispatched program on the device stream and lands on the
        # host before result() asks for it, instead of starting only when
        # result() blocks on np.asarray
        for arr in (f32_pack, i32_pack):
            if arr is not None:
                try:
                    arr.copy_to_host_async()
                except AttributeError:
                    break  # non-jax array (tests stub numpy results)
        # dispatch->fetch wall time equals device time only when fetched
        # immediately; in pipelined mode the fetch is deliberately delayed,
        # so the measurement would include the next batch's host prep
        self._sync_timing = False

    def result(self) -> QueryResult:
        if self._done is not None:
            return self._done
        eng = self._engine
        cfg = eng.config
        B, B_real, k = self._B, self._B_real, self._k
        f32_pack = np.asarray(self._f32)
        i32_pack = np.asarray(self._i32)
        dt_ms = ((time.time() - self._t0) * 1000.0
                 if self._sync_timing else None)
        top_s = f32_pack[:B_real, :k]
        norms_at = np.moveaxis(
            f32_pack[:B_real, k:].reshape(B_real, 3, k), 1, 0)
        top_i = i32_pack[:B_real, :k]
        counts = i32_pack[:B_real, k:]
        if eng.sink and self._trace_id and dt_ms is not None:
            record_device_timing(
                eng.sink, self._trace_id, kernel="engine/query_batch",
                device_ms=dt_ms, shape=f"B{B}xN{eng._n}k{k}",
                backend=jax.default_backend(),
            )
        self._done = QueryResult(
            hits=HitBatch(ids=top_i, scores=top_s),
            channel_norms=norms_at,
            diagnostics={
                "bm25_candidates": int(counts[:, 0].sum()),
                "graph_candidates": int(counts[:, 1].sum()),
                "dense_scored": int(counts[:, 2].sum()),
                "weights": {"alpha_text": cfg.alpha_text,
                            "alpha_graph": cfg.alpha_graph,
                            "alpha_dense": cfg.alpha_dense},
                "pool": {"bm25_pool_k": self._pool_k, "final_top_k": k},
                "graph_window_used": self._window,
                "device_ms": round(dt_ms, 3) if dt_ms is not None else None,
                "batch_bucket": B,
            },
        )
        # release device handles
        self._f32 = self._i32 = None
        return self._done


# ---------------- shared host-side helpers ----------------
# (used by QueryEngine AND parallel.sharded_hybrid.ShardedHybridEngine —
# one implementation so bucketing/encoding/hydration can't drift apart)


def pick_bucket(buckets: Sequence[int], b: int) -> int:
    for s in buckets:
        if b <= s:
            return s
    return b


def build_high_df_terms(bm25, ratio: float, n_docs: int) -> Optional[set]:
    """Tokens whose document frequency exceeds ratio * n_docs (the
    idf-guided query-pruning set); None when pruning is off."""
    if not ratio or not n_docs:
        return None
    df = np.asarray(bm25.df)
    cutoff = ratio * n_docs
    return {t for t, i in bm25.vocab.items() if df[i] > cutoff}


def prune_query(q: str, high_df_terms: Optional[set]) -> str:
    """Drop high-df tokens; fall back to the original when everything
    would drop. NOTE: re-joining tokens fabricates hash-encoder bigrams
    across pruned gaps — accepted: pruning was measured end-to-end with
    exactly this behavior (recall 0.465 -> 0.887), and host prep overlaps
    device execution in pipelined serving."""
    if not high_df_terms or not q:
        return q
    # phrase-augment BEFORE pruning: the re-join lowercases, which would
    # hide the capitalized runs from encode_query_term_ids' augmentation;
    # the phrase pseudo-tokens themselves are low-df and survive the prune.
    # Fused form of `tokenize(phrase_augment(q))` — build the phrase
    # pseudo-tokens straight from the capitalized runs instead of
    # string-concatenating an augmented query and re-tokenizing it (the
    # query prep path runs per batch inside the pipelined loop)
    kept = [t for t in tokenize(q) if t not in high_df_terms]
    if not q.islower():
        for r in capitalized_runs(q):
            if " " in r:
                p = "00".join(tokenize(r))
                if p not in high_df_terms:
                    kept.append(p)
    return " ".join(kept) if kept else q


def encode_query_term_ids(variants: Sequence[Sequence[str]], E: int, T: int,
                          vocab: Dict[str, int], native_vocab=None) -> np.ndarray:
    """[B, E, T] int32 BM25 term ids (-1 padded); native lookup if available.

    Queries get phrase-token augmentation (hash_embed.phrase_augment):
    full capitalized runs become near-unique BM25 terms on phrase-indexed
    corpora; on older indexes the tokens miss the vocab and drop out.
    """
    B = len(variants)
    if native_vocab is not None:
        flat: List[str] = []
        for vs in variants:
            vs = list(vs)[:E]
            flat.extend([phrase_augment(v) if v else "" for v in vs]
                        + [""] * (E - len(vs)))
        return native_vocab.lookup_batch(flat, T).reshape(B, E, T)
    term_ids = np.full((B, E, T), -1, dtype=np.int32)
    for b, vs in enumerate(variants):
        for e, q in enumerate(list(vs)[:E]):
            tids = [vocab[t] for t in tokenize(phrase_augment(q))
                    if t in vocab][:T]
            term_ids[b, e, : len(tids)] = tids
    return term_ids


def prepare_query_variants(
    queries: Sequence[str],
    expansions: Optional[Sequence[Sequence[str]]],
    B: int,
    max_variants: int,
) -> Tuple[List[List[str]], int]:
    """Pad the batch to B, cap variants, and pick the power-of-two variant
    bucket E actually needed (BM25 work scales with E)."""
    variants: List[List[str]] = []
    for i in range(B):
        if i < len(queries):
            v = [queries[i]] + list(expansions[i] if expansions else [])
        else:
            v = [""]
        variants.append(v[:max_variants])
    e_needed = max(len(v) for v in variants)
    E = 1
    while E < e_needed:
        E *= 2
    return variants, min(E, max_variants)


def trim_term_bucket(term_ids: np.ndarray, max_terms: int) -> np.ndarray:
    """Trim [B, E, T] to the power-of-two T bucket actually used (phase-1
    sort width is T * term_topm; typical queries fill ~10 of 32 slots)."""
    used_t = int((term_ids >= 0).any(axis=(0, 1)).nonzero()[0].max() + 1) \
        if (term_ids >= 0).any() else 1
    T_eff = 8
    while T_eff < used_t:
        T_eff *= 2
    return term_ids[:, :, : min(T_eff, max_terms)]


def hydrate_result_hits(corpus, result: "QueryResult", row: int,
                        extra_meta: Optional[Dict[str, Any]] = None):
    """QueryResult row -> List[Hit] with corpus meta + channel norms.

    Single pass that builds each hit's meta dict once: hydration sits on
    the serving hot path at ~10 Hit objects per query."""
    from ..core.dto import Hit

    ids = np.asarray(result.hits.ids)[row].tolist()
    scores = np.asarray(result.hits.scores)[row].tolist()
    norms = np.asarray(result.channel_norms)
    nt, ng, nd = (norms[0, row].tolist(), norms[1, row].tolist(),
                  norms[2, row].tolist())
    hits: List[Any] = []
    for i, (rid, s) in enumerate(zip(ids, scores)):
        if rid < 0:
            continue
        meta = corpus.hit_meta(rid)
        if extra_meta:
            meta.update(extra_meta)
        # norms AFTER extra_meta: they win key collisions
        meta["score_text_norm"] = nt[i]
        meta["score_graph_norm"] = ng[i]
        meta["score_dense_norm"] = nd[i]
        hits.append(Hit(id=corpus.hit_id(rid), score=float(s), meta=meta))
    return hits


class QueryEngine:
    """Holds the packed index resident on device and serves query batches."""

    CHANNELS = ("text", "graph", "dense")
    # query_batch_async accepts prepruned=True (multihop's native bridge
    # emits already-pruned hop-2 queries and skips the per-batch re-prune)
    _supports_prepruned = True

    def __init__(
        self,
        index: PackedIndex,
        *,
        encoder: Optional[Any] = None,
        config: Optional[EngineConfig] = None,
        sink: Optional[TelemetrySink] = None,
        splade_index: Optional[Any] = None,
    ):
        from ..utils.jax_setup import enable_compilation_cache

        enable_compilation_cache()
        self.index = index
        self.config = config or EngineConfig()
        self.sink = sink
        self.encoder = encoder or HashEmbedEncoder(dim=index.embed_dim or 64)

        # device residency (uploaded once; donated nothing — index is read-only)
        emb = index.device_embeddings()
        if emb.size:
            norms = jnp.sqrt(jnp.sum(emb.astype(jnp.float32) ** 2, axis=1, keepdims=True))
            emb = (emb.astype(jnp.float32) / jnp.maximum(norms, 1e-9)).astype(emb.dtype)
        self._emb = emb
        self._nbrs = index.device_graph(include_entity=self.config.include_entity_graph)
        self._n = index.n_docs
        self._jit_cache: Dict[Tuple, Any] = {}

        self._splade_enc = None
        if self.config.sparse_impl == "splade":
            # learned-sparse text channel: SPLADE doc expansions replace the
            # BM25 postings device-side; query expansion runs in-program
            from ..models.splade import SpladeEncoder
            from ..ops.splade import (
                SpladeDeviceIndex,
                splade_engine_arrays,
            )

            if self.config.bm25_impl != "sorted":
                raise ValueError("sparse_impl='splade' requires "
                                 "bm25_impl='sorted' (term_weights ride the "
                                 "sort-aggregate path only)")
            if not self.config.splade_weights:
                raise ValueError("sparse_impl='splade' requires "
                                 "splade_weights (SpladeEncoder checkpoint)")
            self._splade_enc = SpladeEncoder.load(self.config.splade_weights)
            if splade_index is None and self._n:
                splade_index = self._build_splade_index()
            self._bm25 = (splade_engine_arrays(
                splade_index, self._splade_enc.cfg.doc_top_terms)
                if splade_index is not None else {})
            self._splade_index = splade_index
            # the expansion head owns term weighting; idf pruning off
            self._high_df_terms = None
        elif self.config.sparse_impl == "bm25":
            self._bm25 = index.device_bm25()
            # idf-guided query pruning (query_df_ratio_max): host-side set
            # of tokens too common to keep in queries
            self._high_df_terms = build_high_df_terms(
                index.bm25, self.config.query_df_ratio_max, self._n)
        else:
            raise ValueError(f"unknown sparse_impl "
                             f"{self.config.sparse_impl!r} "
                             "(expected bm25 | splade)")

        try:
            from ..native import binding as _nb

            self._native_vocab = _nb.NativeVocab(index.bm25.vocab)
            if not self._native_vocab.available:
                self._native_vocab = None
        except Exception:
            self._native_vocab = None

    def _prune_query(self, q: str) -> str:
        return prune_query(q, self._high_df_terms)

    def _build_splade_index(self):
        """Expand the corpus through the SPLADE encoder in device batches
        (the backend caches the result on disk; bench/test engines build
        in-memory)."""
        from ..ops.splade import SpladeRetriever

        r = SpladeRetriever(self._splade_enc)
        r.build(self.index.corpus.texts())
        return r.index

    # ------------- host-side encoding -------------

    def _bucket(self, b: int) -> int:
        return pick_bucket(self.config.batch_buckets, b)

    def encode_queries(
        self, variants: Sequence[Sequence[str]], n_variants: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (q_emb [B, d] f32, term_ids [B, E, T] int32).

        ``variants[b]`` = [original, expansion1, ...]; the dense channel uses
        the ORIGINAL query embedding only (reference embeds req.query,
        retrieval_backend.py:227), BM25 max-merges over all variants.
        """
        originals = [v[0] if v else "" for v in variants]
        q_emb = np.asarray(self.encoder.encode_texts(list(originals)), dtype=np.float32)
        return q_emb, self.encode_term_ids(variants, n_variants=n_variants)

    def encode_term_ids(
        self, variants: Sequence[Sequence[str]], n_variants: Optional[int] = None
    ) -> np.ndarray:
        """[B, E, T] int32 BM25 term ids only (no query embedding)."""
        cfg = self.config
        return encode_query_term_ids(
            variants, n_variants or cfg.qe_variants, cfg.max_query_terms,
            self.index.bm25.vocab, self._native_vocab,
        )

    def qmatch_seed_rows(self, query: str, candidate_rows: Sequence[int]) -> List[int]:
        """Host q_match: candidate rows sharing >=1 token with the query
        (EdgeBuilder q_match semantics, edge_builder.py:134-143)."""
        q_terms = set(tokenize(query))
        out = []
        for r in candidate_rows:
            text = self.index.corpus.docs[r].get("text", "")
            if q_terms & set(tokenize(text)):
                out.append(int(r))
        return out

    # ------------- the device program -------------

    def _program(self, key: Tuple) -> Any:
        if key in self._jit_cache:
            return self._jit_cache[key]
        (B, E, T, S, pool_k, k, window, seeds_explicit, _weighted,
         fuse_embed) = key
        n = self._n
        cfg = self.config
        sparse_splade = self._splade_enc is not None
        sp_cfg = self._splade_enc.cfg if sparse_splade else None
        if sparse_splade:
            from ..models.splade import apply_splade, sparsify_topk
        cap = min(cfg.bm25_posting_cap, max(int(self._bm25["doc_ids"].shape[0]), 1))
        alphas = jnp.asarray(
            [cfg.alpha_text, cfg.alpha_graph, cfg.alpha_dense], dtype=jnp.float32
        )
        if cfg.graph_impl not in ("auto", "dense", "compact"):
            # a config typo must not silently select the dense [B, N] wave
            # path — at 1M+ rows that is exactly the OOM compact prevents
            raise ValueError(f"unknown graph_impl {cfg.graph_impl!r} "
                             "(expected auto | dense | compact)")
        if cfg.graph_impl == "compact" and cfg.fusion_impl != "compact":
            raise ValueError(
                "graph_impl='compact' requires fusion_impl='compact' "
                "(the dense fusion oracle needs [B, N] graph scores)")
        use_compact_graph = cfg.fusion_impl == "compact" and (
            cfg.graph_impl == "compact"
            or (cfg.graph_impl == "auto" and B * n * 4 > 256 << 20)
        )
        if cfg.dense_impl not in ("auto", "pool", "matmul"):
            # a typo must not silently fall back to the pool formulation —
            # pool and matmul agree to f32 tolerance, so there would be no
            # behavioral signal that the requested throughput mode is off
            raise ValueError(f"unknown dense_impl {cfg.dense_impl!r} "
                             "(expected auto | pool | matmul)")
        if cfg.dense_impl == "matmul" and use_compact_graph:
            # compact mode exists precisely to avoid [B, N] buffers; a
            # [4096, 5.17M] f32 dense-score matrix is an 84GB OOM
            raise ValueError(
                "dense_impl='matmul' materializes [B, N] dense scores and "
                "cannot be combined with the compact graph path; use "
                "dense_impl='pool' (or 'auto') at corpus scale")

        def _pack_outputs(top_s, top_i, norms_at, counts):
            if cfg.order_alphas is not None:
                top_s, top_i, norms_at = reorder_hits(
                    top_s, top_i, norms_at, cfg.order_alphas)
            # two output arrays instead of four: one device->host copy each
            f32_pack = jnp.concatenate(
                [top_s, norms_at.reshape(B, -1)], axis=1)
            i32_pack = jnp.concatenate(
                [top_i.astype(jnp.int32), counts.astype(jnp.int32)], axis=1)
            return f32_pack, i32_pack

        def program(*args):
            # the index rides as an explicit argument tree, NOT a closure:
            # closed-over arrays serialize into the lowered program as
            # constants (81MB of MLIR at N=97k)
            *args, index_tree = args
            emb, nbrs, bm = (index_tree["emb"], index_tree["nbrs"],
                             index_tree["bm"])
            term_w = None
            if sparse_splade:
                # learned-sparse query side: expansion head runs IN-program
                # (one trunk pass over the B*E variant rows); term ids and
                # weights feed the same posting machinery as BM25
                if fuse_embed:
                    feat_a, feat_b, sp_ids, sp_mask, seed_rows = args
                    q_emb = self.encoder.device_embed(feat_a, feat_b)
                else:
                    q_emb, sp_ids, sp_mask, seed_rows = args
                w_exp = apply_splade(index_tree["sp"], sp_ids, sp_mask,
                                     sp_cfg)
                t_ids, t_w = sparsify_topk(w_exp, T)
                term_ids = t_ids.reshape(B, E, T)
                term_w = t_w.reshape(B, E, T)
            elif fuse_embed:
                feat_a, feat_b, term_ids, seed_rows = args
                q_emb = self.encoder.device_embed(feat_a, feat_b)
            else:
                q_emb, term_ids, seed_rows = args
            # ---- text channel: BM25 max-merged over query variants ----
            if cfg.bm25_impl == "sorted":
                # two-phase scatter-free BM25: sort-aggregate candidate pool
                # (term_topm window, approximate membership at the tail) +
                # EXACT doc-major re-score of the selected pool
                pool_s, pool_i = bm25_topk_sorted(
                    term_ids, bm["doc_ids"], bm["scores"], bm["row_ptr"],
                    n_docs=n, term_topm=min(cfg.bm25_term_topm, cap),
                    pool_k=pool_k,
                    posting_packed=bm.get("posting_packed"),
                    term_weights=term_w,
                )
                pad = pool_k - pool_s.shape[1]
                if pad > 0:
                    pool_s = jnp.pad(pool_s, ((0, 0), (0, pad)))
                    pool_i = jnp.pad(pool_i, ((0, 0), (0, pad)),
                                     constant_values=-1)
                pool_s = bm25_rescore_pool(
                    pool_i, term_ids, bm["doc_terms_padded"],
                    bm["doc_scores_padded"], n_docs=n, term_weights=term_w,
                )
                pool_s, pool_i = canonical_pool_order(pool_s, pool_i)
                pool_valid = (pool_s > 0) & (pool_i >= 0)
                text_scores = None  # no [B, N] text buffer in this mode
            else:
                text_scores = bm25_scores_batched(
                    term_ids, bm["doc_ids"], bm["scores"], bm["row_ptr"],
                    n_docs=n, cap=cap, merge="max",
                )  # [B, N]
                pool_s, pool_i = jax.lax.top_k(text_scores, pool_k)
                pool_valid = pool_s > 0
            rows_b = jnp.broadcast_to(jnp.arange(B)[:, None], (B, pool_k))
            safe_pool = jnp.where(pool_valid, pool_i, n)

            # ---- dense channel: cosine(q, pool rows) ----
            qn = q_emb / jnp.maximum(
                jnp.sqrt(jnp.sum(q_emb * q_emb, axis=1, keepdims=True)), 1e-9
            )
            use_dense_matmul = cfg.dense_impl == "matmul"
            if use_dense_matmul:
                # [B, N] = Q @ Eᵀ, then a scalar gather at the pool ids
                # (only taken in the dense-graph regime where a [B, N]
                # buffer already exists)
                dense_all = jnp.einsum(
                    "bd,nd->bn", qn, emb.astype(jnp.float32),
                    precision=DENSE_PRECISION,
                    preferred_element_type=jnp.float32,
                )
                dense_pool = jnp.take_along_axis(
                    dense_all, jnp.where(pool_valid, pool_i, 0), axis=1)
            else:
                pool_emb = jnp.take(
                    emb, jnp.where(pool_valid, pool_i, 0), axis=0)
                dense_pool = jnp.einsum(
                    "bd,bkd->bk", qn, pool_emb.astype(jnp.float32),
                    precision=DENSE_PRECISION,
                    preferred_element_type=jnp.float32,
                )
            dense_pool = jnp.where(pool_valid, dense_pool, 0.0)

            # ---- graph channel: frontier expansion with hop decay ----
            if use_compact_graph:
                # N-independent path: compact seeds -> compact waves ->
                # compact pool. No [B, N] buffer exists anywhere in the
                # program in this mode (BM25 is sorted/pool, dense is pool,
                # fusion is pool-compact), so batch size is no longer
                # capped by corpus size.
                P_g = min(pool_k, n)
                if seeds_explicit:
                    c_seed_ids = seed_rows
                    c_seed_vals = (seed_rows >= 0).astype(jnp.float32)
                else:
                    # cfg.max_seed_rows, NOT the key's S (the seed
                    # argument's width — a [B, 1] placeholder here)
                    S_eff = min(cfg.max_seed_rows, pool_k)
                    top_seed_s, seed_pos = jax.lax.top_k(pool_s, S_eff)
                    c_seed_ids = jnp.take_along_axis(pool_i, seed_pos, axis=1)
                    seed_ok = (top_seed_s > 0) & (c_seed_ids >= 0)
                    if cfg.graph_seed_weighted:
                        denom = jnp.maximum(top_seed_s[:, :1], 1e-9)
                        c_seed_vals = jnp.where(
                            seed_ok, top_seed_s / denom, 0.0)
                    else:
                        c_seed_vals = seed_ok.astype(jnp.float32)
                g_pool_s, g_pool_i = expand_frontier_weighted_compact(
                    nbrs, c_seed_ids, c_seed_vals, window=window,
                    cap=cfg.graph_compact_cap, out_k=P_g,
                )
                g_valid = (g_pool_s > 0) & (g_pool_i >= 0)
                counts = jnp.stack(
                    [jnp.sum(pool_valid, axis=1), jnp.sum(g_valid, axis=1),
                     jnp.sum(pool_valid, axis=1)], axis=1,
                )
                # graph value at text-pool ids = membership lookup in the
                # graph pool (fuse_pools_compact ignores sub-g_lo values, so
                # the top-P_g pool is a sufficient statistic for fusion)
                eq = pool_i[:, :, None] == jnp.where(
                    g_valid, g_pool_i, -2)[:, None, :]
                t_graph_raw = jnp.max(
                    jnp.where(eq, g_pool_s[:, None, :], 0.0), axis=2)
                top_s, top_i, norms_at = fuse_pools_compact(
                    pool_s, pool_i, pool_valid, dense_pool, t_graph_raw,
                    g_pool_s, g_pool_i, g_valid, alphas=alphas, k=k, n=n,
                )
                return _pack_outputs(top_s, top_i, norms_at, counts)

            # dense path: the vmapped row-gather expansion materializes
            # [B, N, deg] f32 per hop; when that exceeds ~2GB, switch to the
            # batched per-degree-column formulation (same semantics and
            # bytes, no giant intermediate — 27GB at B=2048/N=100k/deg=34
            # otherwise). An explicit cfg.frontier_cap still selects the
            # capped variant.
            deg = int(nbrs.shape[1]) if getattr(nbrs, "ndim", 0) == 2 else 1
            frontier_cap = cfg.frontier_cap
            use_batched_expand = (
                frontier_cap is None
                and B * n * max(deg, 1) * 4 > 2 << 30
            )
            if seeds_explicit:
                rows_s = jnp.broadcast_to(jnp.arange(B)[:, None], (B, S))
                if use_batched_expand:
                    # uniform seeds: weighted expansion with value 1.0 is
                    # exactly decay(min distance) — expand_frontier parity
                    seed_scores = (
                        jnp.zeros((B, n + 1), dtype=jnp.float32)
                        .at[rows_s, jnp.where(seed_rows >= 0, seed_rows, n)]
                        .max(jnp.where(seed_rows >= 0, 1.0, 0.0))[:, :n]
                    )
                    graph_scores = expand_frontier_weighted_batched(
                        nbrs, seed_scores, window=window,
                        wave_dtype=cfg.graph_wave_dtype)
                else:
                    seed_mask = (
                        jnp.zeros((B, n + 1), dtype=jnp.bool_)
                        .at[rows_s, jnp.where(seed_rows >= 0, seed_rows, n)]
                        .set(True)[:, :n]
                    )

                    def one_expand(sm):
                        s, _ = expand_frontier(nbrs, sm, window=window,
                                               frontier_cap=frontier_cap)
                        return s

                    graph_scores = jax.vmap(one_expand)(seed_mask)  # [B, N]
            else:
                # NOT the key's S — that is the seed ARGUMENT's width,
                # a [B, 1] placeholder when seeds are derived on device
                S_eff = min(cfg.max_seed_rows, pool_k)
                # seeds = strongest BM25 pool entries
                top_seed_s, seed_pos = jax.lax.top_k(pool_s, S_eff)
                top_seed_i = jnp.take_along_axis(pool_i, seed_pos, axis=1)
                rows_s = jnp.broadcast_to(jnp.arange(B)[:, None], (B, S_eff))
                seed_ok = (top_seed_s > 0) & (top_seed_i >= 0)
                if cfg.graph_seed_weighted:
                    # seed strength = bm25 / max(bm25): strongest seed -> 1.0
                    denom = jnp.maximum(top_seed_s[:, :1], 1e-9)
                    seed_vals = jnp.where(seed_ok, top_seed_s / denom, 0.0)
                    seed_scores = (
                        jnp.zeros((B, n + 1), dtype=jnp.float32)
                        .at[rows_s, jnp.where(seed_ok, top_seed_i, n)]
                        .max(seed_vals)[:, :n]
                    )

                    if use_batched_expand:
                        graph_scores = expand_frontier_weighted_batched(
                            nbrs, seed_scores, window=window,
                            wave_dtype=cfg.graph_wave_dtype)
                    elif frontier_cap:
                        def one_expand_w(sv):
                            return expand_frontier_weighted_capped(
                                nbrs, sv, window=window,
                                frontier_cap=frontier_cap)

                        graph_scores = jax.vmap(one_expand_w)(seed_scores)
                    else:
                        def one_expand_w(sv):
                            return expand_frontier_weighted(
                                nbrs, sv, window=window,
                                wave_dtype=cfg.graph_wave_dtype)

                        graph_scores = jax.vmap(one_expand_w)(seed_scores)
                else:
                    seed_mask = (
                        jnp.zeros((B, n + 1), dtype=jnp.bool_)
                        .at[rows_s, jnp.where(seed_ok, top_seed_i, n)]
                        .set(True)[:, :n]
                    )

                    def one_expand(sm):
                        s, _ = expand_frontier(nbrs, sm, window=window,
                                               frontier_cap=frontier_cap)
                        return s

                    graph_scores = jax.vmap(one_expand)(seed_mask)  # [B, N]

            P_g = min(pool_k, n)
            if n > cfg.graph_pool_approx_from and not cfg.graph_pool_exact:
                # exact on the GPU and the CPU (XLA's sort fallback for
                # approx_max_k); see EngineConfig.graph_pool_approx_from
                g_pool_s, g_pool_i = jax.lax.approx_max_k(graph_scores, P_g)
            else:
                g_pool_s, g_pool_i = jax.lax.top_k(graph_scores, P_g)
            g_valid = g_pool_s > 0

            counts = jnp.stack(
                [jnp.sum(pool_valid, axis=1), jnp.sum(g_valid, axis=1),
                 jnp.sum(pool_valid, axis=1)], axis=1,
            )

            if cfg.fusion_impl == "compact":
                top_s, top_i, norms_at = _fuse_compact(
                    pool_s, pool_i, pool_valid, dense_pool, graph_scores,
                    g_pool_s, g_pool_i, g_valid)
                return _pack_outputs(top_s, top_i, norms_at, counts)

            # ---- dense fusion (the [B, N] oracle path) ----
            text_dense = (
                jnp.zeros((B, n + 1), dtype=jnp.float32)
                .at[rows_b, safe_pool]
                .set(jnp.where(pool_valid, pool_s, 0.0))[:, :n]
            ) if text_scores is None else jnp.where(
                (jnp.zeros((B, n + 1), dtype=jnp.bool_)
                 .at[rows_b, safe_pool].set(True)[:, :n]), text_scores, 0.0)
            text_present = (
                jnp.zeros((B, n + 1), dtype=jnp.bool_)
                .at[rows_b, safe_pool]
                .set(True)[:, :n]
            )
            dense_scores = (
                jnp.zeros((B, n + 1), dtype=jnp.float32)
                .at[rows_b, safe_pool]
                .set(dense_pool)[:, :n]
            )
            rows_g = jnp.broadcast_to(jnp.arange(B)[:, None], (B, P_g))
            graph_present = (
                jnp.zeros((B, n + 1), dtype=jnp.bool_)
                .at[rows_g, jnp.where(g_valid, g_pool_i, n)]
                .set(True)[:, :n]
            )
            graph_channel = jnp.where(graph_present, graph_scores, 0.0)

            ch_scores = jnp.stack([text_dense, graph_channel, dense_scores],
                                  axis=1)  # [B, 3, N]
            ch_present = jnp.stack(
                [text_present, graph_present, text_present], axis=1
            )

            def one_fuse(cs, cp):
                return fuse_channels(cs, cp, alphas, k=k)

            top_s, top_i, normed = jax.vmap(one_fuse)(ch_scores, ch_present)
            safe_i = jnp.where(top_i >= 0, top_i, 0)
            norms_at = jnp.take_along_axis(
                normed, safe_i[:, None, :], axis=2
            )  # [B, 3, k]
            return _pack_outputs(top_s, top_i, norms_at, counts)

        def _fuse_compact(pool_s, pool_i, pool_valid, dense_pool,
                          graph_scores, g_pool_s, g_pool_i, g_valid):
            """Pool-compact fusion via the shared `ops.fusion.fuse_pools_compact`
            (also the fusion stage of the sharded hybrid engine)."""
            safe_ids = jnp.clip(pool_i, 0, max(n - 1, 0))
            t_graph_raw = jnp.take_along_axis(graph_scores, safe_ids, axis=1)
            return fuse_pools_compact(
                pool_s, pool_i, pool_valid, dense_pool, t_graph_raw,
                g_pool_s, g_pool_i, g_valid, alphas=alphas, k=k, n=n,
            )

        fn = jax.jit(program)
        self._jit_cache[key] = fn
        return fn

    # ------------- public API -------------

    def query_batch(
        self,
        queries: Sequence[str],
        *,
        expansions: Optional[Sequence[Sequence[str]]] = None,
        seed_rows: Optional[Sequence[Sequence[int]]] = None,
        top_k: Optional[int] = None,
        graph_window: Optional[int] = None,
        trace_id: str = "",
        prepruned: bool = False,
        pool_k: Optional[int] = None,
    ) -> QueryResult:
        """Synchronous query: dispatch + fetch in one call."""
        pending = self.query_batch_async(
            queries, expansions=expansions, seed_rows=seed_rows,
            top_k=top_k, graph_window=graph_window, trace_id=trace_id,
            prepruned=prepruned, pool_k=pool_k,
        )
        pending._sync_timing = True
        return pending.result()

    def query_batches_pipelined(
        self, batches: Sequence[Sequence[str]], **kw
    ):
        """Generator over query batches with one batch always in flight:
        host prep + dispatch run on a worker thread while the caller
        thread blocks fetching the previous batch (the fetch wait releases
        the GIL, so prep genuinely overlaps). Depth 3 = one batch being
        fetched + one executing on device + one being prepped. Steady-state
        throughput approaches the pure device program rate regardless of
        host-side query-prep cost (tokenize/prune/phrase-augment) while
        that cost stays below the device program's time."""
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        pool = getattr(self, "_prep_pool", None)
        if pool is None:
            pool = self._prep_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="amrf-prep")
        pending: deque = deque()
        for b in batches:
            pending.append(pool.submit(self.query_batch_async, b, **kw))
            if len(pending) >= 3:
                yield pending.popleft().result().result()
        while pending:
            yield pending.popleft().result().result()

    def query_batch_async(
        self,
        queries: Sequence[str],
        *,
        expansions: Optional[Sequence[Sequence[str]]] = None,
        seed_rows: Optional[Sequence[Sequence[int]]] = None,
        top_k: Optional[int] = None,
        graph_window: Optional[int] = None,
        trace_id: str = "",
        prepruned: bool = False,
        pool_k: Optional[int] = None,
    ) -> "PendingQuery":
        """Dispatch the device program and return without blocking; call
        ``.result()`` on the returned handle to fetch the QueryResult.

        ``prepruned=True`` asserts the caller already applied
        ``prune_query`` (the iterative mode's native bridge emits pruned
        hop-2 variants) — the per-batch re-prune is skipped.

        ``pool_k`` overrides ``cfg.pool_k`` for this dispatch (a narrower
        candidate pool shrinks every pool-width stage: phase-1 sort,
        doc-major rescore, dense gather, fusion sort). The iterative
        mode's hop-2 program rides this (EngineConfig.hop2_pool_k):
        hop-2 queries name the bridge title, so the gold doc sits at the
        pool's head and the reference-parity width is dead work there."""
        cfg = self.config
        B_real = len(queries)
        if self._n == 0 or B_real == 0:
            empty = HitBatch(
                ids=np.full((B_real, top_k or cfg.top_k), -1, np.int32),
                scores=np.zeros((B_real, top_k or cfg.top_k), np.float32),
            )
            return PendingQuery(done=QueryResult(
                hits=empty,
                channel_norms=np.zeros((3, B_real, top_k or cfg.top_k)),
                diagnostics={"empty_index": self._n == 0}))

        k = min(int(top_k or cfg.top_k), self._n)
        window = cfg.graph_window if graph_window is None else max(0, int(graph_window))
        pool_k = min(int(pool_k or cfg.pool_k), self._n)
        pool_k = max(pool_k, k)  # the pool must at least cover the output
        B = self._bucket(B_real)

        if self._high_df_terms and not prepruned:
            queries = [self._prune_query(q) for q in queries]
            if expansions is not None:
                expansions = [[self._prune_query(e) for e in ex]
                              for ex in expansions]
        variants, E = prepare_query_variants(queries, expansions, B,
                                             cfg.qe_variants)
        # query embedding is fused into the device program when the encoder
        # exposes host_featurize/device_embed — one dispatch instead of two
        fuse_embed = hasattr(self.encoder, "host_featurize") and hasattr(
            self.encoder, "device_embed"
        )
        sp_args: Optional[Tuple[np.ndarray, np.ndarray]] = None
        if self._splade_enc is not None:
            # learned-sparse mode: featurize every variant row for the
            # in-program expansion head; no host-side vocab lookup
            flat = [v[e] if e < len(v) else ""
                    for v in variants for e in range(E)]
            sp_args = self._splade_enc.host_featurize(flat)
            term_ids = None
            T_eff = int(self._splade_enc.cfg.query_top_terms)
            if fuse_embed:
                originals = [v[0] if v else "" for v in variants]
                feats = self.encoder.host_featurize(originals)
            else:
                originals = [v[0] if v else "" for v in variants]
                q_emb = np.asarray(
                    self.encoder.encode_texts(list(originals)),
                    dtype=np.float32)
        elif fuse_embed:
            originals = [v[0] if v else "" for v in variants]
            feats = self.encoder.host_featurize(originals)
            term_ids = self.encode_term_ids(variants, n_variants=E)
        else:
            q_emb, term_ids = self.encode_queries(variants, n_variants=E)
        if term_ids is not None:
            term_ids = trim_term_bucket(term_ids, cfg.max_query_terms)
            T_eff = term_ids.shape[2]

        seeds_explicit = seed_rows is not None
        # without explicit seeds the program derives seeds from the BM25
        # pool and never reads this argument — ship a [B, 1] placeholder
        # instead of [B, max_seed_rows] of -1s
        S = cfg.max_seed_rows if seeds_explicit else 1
        seed_arr = np.full((B, S), -1, dtype=np.int32)
        if seeds_explicit:
            for i in range(min(B_real, B)):
                rows = list(seed_rows[i])[:S]
                seed_arr[i, : len(rows)] = rows

        key = (B, E, T_eff, S, pool_k, k, window,
               seeds_explicit, cfg.graph_seed_weighted, fuse_embed)
        fn = self._program(key)

        index_tree = {"emb": self._emb, "nbrs": self._nbrs, "bm": self._bm25}
        if self._splade_enc is not None:
            index_tree["sp"] = self._splade_enc.params
        t0 = time.time()
        if sp_args is not None:
            head = ((jnp.asarray(feats[0]), jnp.asarray(feats[1]))
                    if fuse_embed else (jnp.asarray(q_emb),))
            f32_pack, i32_pack = fn(
                *head, jnp.asarray(sp_args[0]), jnp.asarray(sp_args[1]),
                jnp.asarray(seed_arr), index_tree
            )
        elif fuse_embed:
            f32_pack, i32_pack = fn(
                jnp.asarray(feats[0]), jnp.asarray(feats[1]),
                jnp.asarray(term_ids), jnp.asarray(seed_arr), index_tree
            )
        else:
            f32_pack, i32_pack = fn(
                jnp.asarray(q_emb), jnp.asarray(term_ids),
                jnp.asarray(seed_arr), index_tree
            )
        return PendingQuery(
            engine=self, f32_pack=f32_pack, i32_pack=i32_pack, B=B,
            B_real=B_real, k=k, pool_k=pool_k, window=window, t0=t0,
            trace_id=trace_id,
        )

    # ------------- pure-dense retrieval (BASELINE config 2) -------------

    def query_dense_batch(
        self,
        queries: Sequence[str],
        *,
        top_k: Optional[int] = None,
    ) -> QueryResult:
        """Brute-force dense retrieval over the FULL corpus: exact cosine
        top-k via `ops.topk.dense_topk`. No BM25/graph channels; this is the
        exact-dense-index path of BASELINE.json config 2."""
        from ..ops.topk import dense_topk

        B_real = len(queries)
        k = min(int(top_k or self.config.top_k), self._n)
        if self._n == 0 or B_real == 0:
            empty = HitBatch(ids=np.full((B_real, k or 1), -1, np.int32),
                             scores=np.zeros((B_real, k or 1), np.float32))
            return QueryResult(hits=empty,
                               channel_norms=np.zeros((3, B_real, k or 1)),
                               diagnostics={"empty_index": self._n == 0})
        B = self._bucket(B_real)
        padded = list(queries) + [""] * (B - B_real)
        q = jnp.asarray(
            np.asarray(self.encoder.encode_texts(padded), dtype=np.float32)
        )
        t0 = time.time()
        s, i = dense_topk(q, self._emb, k)
        s = np.asarray(s)[:B_real]
        dt_ms = (time.time() - t0) * 1000.0
        i = np.asarray(i)[:B_real]
        return QueryResult(
            hits=HitBatch(ids=i, scores=s),
            channel_norms=np.zeros((3, B_real, k), dtype=np.float32),
            diagnostics={"mode": "dense_only", "device_ms": round(dt_ms, 3),
                         "batch_bucket": B},
        )

    # ------------- ops / recovery -------------

    def profile(self, trace_dir: str):
        """Context manager: capture a jax.profiler trace of engine activity
        (the device-side complement of the JSONL span telemetry)."""
        return jax.profiler.trace(trace_dir)

    def reload(self) -> None:
        """Recover from device loss: re-upload the packed index to the device and
        drop compiled programs (SURVEY.md §5 failure-recovery obligation:
        device failures are handled by re-init + index reload)."""
        index = self.index
        emb = index.device_embeddings()
        if emb.size:
            norms = jnp.sqrt(jnp.sum(emb.astype(jnp.float32) ** 2, axis=1,
                                     keepdims=True))
            emb = (emb.astype(jnp.float32) / jnp.maximum(norms, 1e-9)).astype(emb.dtype)
        self._emb = emb
        if self._splade_enc is not None:
            from ..ops.splade import splade_engine_arrays

            self._bm25 = (splade_engine_arrays(
                self._splade_index, self._splade_enc.cfg.doc_top_terms)
                if self._splade_index is not None else {})
        else:
            self._bm25 = index.device_bm25()
        self._nbrs = index.device_graph(
            include_entity=self.config.include_entity_graph
        )
        self._jit_cache.clear()

    # ------------- host hydration -------------

    def hydrate_hits(self, result: QueryResult, row: int, extra_meta: Optional[Dict[str, Any]] = None):
        """QueryResult row -> List[Hit] with corpus meta + channel norms."""
        return hydrate_result_hits(self.index.corpus, result, row, extra_meta)
