"""Sharded hybrid engine — BM25 + graph + dense over a row-sharded corpus.

SURVEY.md §2b names index sharding "the parallelism that actually matters
here"; round 1 sharded only the dense channel. This engine shards ALL THREE
channels of the hybrid program over the ``data`` mesh axis:

- **BM25**: each term's phase-1 window (its first ``term_topm`` postings
  over the whole corpus) is split by document row range — each shard
  holds its rows' share of every window, runs the scatter-free phase-1
  selection locally, and each query variant's per-shard pools merge with
  one ``all_gather`` (s * pool_k candidates per variant, never [B, N]);
  the merged pool is re-scored exactly on the shards that own its ids
  and assembled with a ``psum``.
- **dense**: each shard scores the global pool ids it owns against its
  local embedding rows; a ``psum`` assembles the full pool cosine vector
  (each id is owned by exactly one shard, so the sum is exact).
- **graph**: the hop wave is computed by sharded gather-max — each shard
  gathers the replicated wave at its local rows' neighbor ids (the
  N*deg gather cost splits s ways) and an ``all_gather`` rebuilds the
  wave. Semantics identical to `ops.graph.expand_frontier_weighted`.
- **fusion**: the shared `ops.fusion.fuse_pools_compact` runs replicated
  over the merged pools — bit-for-bit the single-chip fusion.

Tie-breaking matches the single-chip engine: per-shard pools are ordered
(score desc, local id asc) and shards concatenate in row order, so the
merged ``top_k`` resolves equal scores by ascending global id — the same
order the single-chip sort produces.

Exactness: the shards see exactly the single-chip windows, phase-1 sums
each doc's window contributions in the same order, and the merge keeps
each variant's corpus-wide top pool, so the BM25 pool is the single-chip
pool at any ``term_topm`` and ``qe_variants`` (asserted by tests and
``dryrun_multichip``). The single-chip engine selects its graph pool
with approx_max_k at n > 4096 unless ``graph_pool_exact`` is set; XLA
lowers that to an exact sort on the GPU and the CPU, the same selection
this engine makes.

Memory: index rows (embeddings, CSR, doc tables, adjacency) are fully
sharded — per-chip residency is N/s rows. The graph channel follows
``EngineConfig.graph_impl``: the dense formulation keeps a replicated
[B, N] wave during expansion (right at small N), while ``compact``
(auto-selected above the same ~256MB threshold as the single-chip engine)
keeps the wave as (ids, vals) pairs and rebuilds each hop's [B, C, deg]
candidate rows with an owned-rows local gather + one ``pmax`` all-reduce —
no [B, N] buffer anywhere in the sharded program, so large batches work at
1M+ rows per shard. Both formulations are bit-for-bit against their
single-chip counterparts (`ops.graph.expand_frontier_weighted_compact_core`
is literally the shared trace).
"""
from __future__ import annotations

import functools
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.dto import HitBatch
from ..engine.query_engine import DENSE_PRECISION, EngineConfig, QueryResult
from ..index.packed import PackedIndex
from ..models.hash_embed import HashEmbedEncoder
from ..ops.bm25 import (bm25_rescore_pool, bm25_variant_pools,
                        canonical_pool_order, merge_variant_pools)
from ..ops.fusion import fuse_pools_compact, reorder_hits
from ..ops.graph import (expand_frontier_weighted_compact_core,
                         hop_decay_table)
from .mesh import build_mesh


def shard_hybrid_arrays(index: PackedIndex, n_shards: int,
                        *, doc_cap: int = 64,
                        include_entity: bool = True,
                        term_window: Optional[int] = None
                        ) -> Dict[str, np.ndarray]:
    """Split the packed index into per-shard host arrays.

    Row arrays ([N, ...]) are padded to a shard multiple and sharded on
    axis 0; the CSR is re-cut per document range and stacked on a leading
    shard axis, postings in their contribution-descending order within
    each term. ``term_window`` keeps only each term's first
    ``term_window`` postings of the whole corpus (the one-device engine's
    phase-1 window), so a shard's postings of a term are exactly its share
    of that window.
    """
    bm = index.bm25
    N = index.n_docs
    V = max(len(bm.row_ptr) - 1, 0)
    n_pad = -(-max(N, 1) // n_shards) * n_shards
    n_local = n_pad // n_shards

    # ---- embeddings (normalized exactly like QueryEngine.__init__) ----
    emb = np.asarray(index.embeddings)
    if index.embed_dtype == "bfloat16" and emb.dtype == np.uint16:
        emb = np.asarray(jnp.asarray(emb).view(jnp.bfloat16).astype(jnp.float32))
    else:
        emb = emb.astype(np.float32)
    if emb.size:
        norms = np.sqrt(np.sum(emb ** 2, axis=1, keepdims=True))
        emb = emb / np.maximum(norms, 1e-9)
        if index.embed_dtype == "bfloat16":
            emb = np.asarray(jnp.asarray(emb).astype(jnp.bfloat16)
                             .astype(jnp.float32))
    d = emb.shape[1] if emb.ndim == 2 and emb.size else (index.embed_dim or 64)
    emb_pad = np.zeros((n_pad, d), dtype=np.float32)
    if emb.size:
        emb_pad[:N] = emb

    # ---- per-shard CSR ----
    doc_ids = np.asarray(bm.doc_ids, dtype=np.int64)
    scores = np.asarray(bm.ensure_scores(), dtype=np.float32)
    row_ptr = np.asarray(bm.row_ptr, dtype=np.int64)
    term_of = (np.repeat(np.arange(V), np.diff(row_ptr))
               if doc_ids.size else np.zeros(0, dtype=np.int64))
    if term_window is not None and doc_ids.size:
        rank = np.arange(doc_ids.size) - row_ptr[term_of]
        keep = rank < term_window
        doc_ids, scores, term_of = doc_ids[keep], scores[keep], term_of[keep]

    csr_ids: List[np.ndarray] = []
    csr_scores: List[np.ndarray] = []
    csr_rp: List[np.ndarray] = []
    for sh in range(n_shards):
        lo, hi = sh * n_local, (sh + 1) * n_local
        mask = (doc_ids >= lo) & (doc_ids < hi)
        csr_ids.append((doc_ids[mask] - lo).astype(np.int32))
        csr_scores.append(scores[mask])
        counts = np.bincount(term_of[mask], minlength=V) if V else np.zeros(0)
        rp = np.zeros(V + 1, dtype=np.int32)
        if V:
            rp[1:] = np.cumsum(counts)
        csr_rp.append(rp)
    nnz_max = max((a.shape[0] for a in csr_ids), default=0) + 1
    ids_stack = np.zeros((n_shards, nnz_max), dtype=np.int32)
    sc_stack = np.zeros((n_shards, nnz_max), dtype=np.float32)
    for sh in range(n_shards):
        ids_stack[sh, : csr_ids[sh].shape[0]] = csr_ids[sh]
        sc_stack[sh, : csr_scores[sh].shape[0]] = csr_scores[sh]
    rp_stack = np.stack(csr_rp, axis=0)

    # ---- doc-major tables (-2 padded terms, like doc_major_padded) ----
    dt, ds = bm.doc_major_padded(doc_cap)
    dt_pad = np.full((n_pad, dt.shape[1] if dt.ndim == 2 else doc_cap), -2,
                     dtype=np.int32)
    ds_pad = np.zeros_like(dt_pad, dtype=np.float32)
    if dt.size:
        dt_pad[:N] = dt
        ds_pad[:N] = ds

    # ---- adjacency (global neighbor ids, rows sharded) ----
    nxt = np.ascontiguousarray(index.graph_next)
    if include_entity and index.graph_entity.size:
        nbrs = np.concatenate(
            [nxt, np.ascontiguousarray(index.graph_entity)], axis=1)
    else:
        nbrs = nxt
    deg = nbrs.shape[1] if nbrs.ndim == 2 and nbrs.size else 1
    nbrs_pad = np.full((n_pad, deg), -1, dtype=np.int32)
    if nbrs.size:
        nbrs_pad[:N] = nbrs

    return {
        "emb": emb_pad, "csr_doc_ids": ids_stack, "csr_scores": sc_stack,
        "csr_row_ptr": rp_stack, "doc_terms": dt_pad, "doc_scores": ds_pad,
        "nbrs": nbrs_pad, "n_docs": N, "n_pad": n_pad, "n_local": n_local,
        "vocab_size": V,
    }


class ShardedHybridEngine:
    """Multi-chip hybrid serving: same query semantics as `QueryEngine`,
    index rows sharded over the mesh's ``data`` axis."""

    CHANNELS = ("text", "graph", "dense")
    # same prepruned contract as QueryEngine.query_batch_async
    _supports_prepruned = True

    def __init__(
        self,
        index: PackedIndex,
        *,
        mesh: Optional[Mesh] = None,
        axis: str = "data",
        encoder: Optional[Any] = None,
        config: Optional[EngineConfig] = None,
        sink: Optional[Any] = None,
    ):
        self.index = index
        self.sink = sink
        self.mesh = mesh or build_mesh({axis: -1})
        self.axis = axis
        # Any OTHER mesh axes (the outermost composed ``dcn_axes`` from
        # mesh_from_settings) become data-parallel over the query batch:
        # the index is replicated per dcn group (P(axis) leaves extra mesh
        # dims unsharded), the batch splits across groups, and every
        # collective inside the program names only ``axis``, so the dcn
        # axes carry no mid-program traffic.
        self.dp_axes = tuple(a for a in self.mesh.axis_names if a != axis)
        self._dp_size = int(np.prod([self.mesh.shape[a]
                                     for a in self.dp_axes], dtype=np.int64)
                            ) if self.dp_axes else 1
        self.config = config or EngineConfig()
        self.encoder = encoder or HashEmbedEncoder(dim=index.embed_dim or 64)
        self._n = index.n_docs

        n_shards = self.mesh.shape[axis]
        # the one-device engine's phase-1 window (QueryEngine._program)
        nnz = int(np.asarray(index.bm25.doc_ids).shape[0])
        self._term_topm = max(min(self.config.bm25_term_topm,
                                  self.config.bm25_posting_cap, nnz), 1)
        host = shard_hybrid_arrays(
            index, n_shards,
            doc_cap=self.config.bm25_doc_cap,
            include_entity=self.config.include_entity_graph,
            term_window=self._term_topm,
        )
        self._n_local = host["n_local"]
        self._n_pad = host["n_pad"]
        row_sh = NamedSharding(self.mesh, P(axis, None))
        shard_sh = NamedSharding(self.mesh, P(axis, None))
        self._arr = {
            "emb": jax.device_put(host["emb"], row_sh),
            "doc_terms": jax.device_put(host["doc_terms"], row_sh),
            "doc_scores": jax.device_put(host["doc_scores"], row_sh),
            "nbrs": jax.device_put(host["nbrs"], row_sh),
            "csr_doc_ids": jax.device_put(host["csr_doc_ids"], shard_sh),
            "csr_scores": jax.device_put(host["csr_scores"], shard_sh),
            "csr_row_ptr": jax.device_put(host["csr_row_ptr"], shard_sh),
        }
        self._jit_cache: Dict[Tuple, Any] = {}
        try:
            from ..native import binding as _nb

            self._native_vocab = _nb.NativeVocab(index.bm25.vocab)
            if not self._native_vocab.available:
                self._native_vocab = None
        except Exception:
            self._native_vocab = None
        # idf-guided query pruning — shared helper, same rule as
        # QueryEngine
        from ..engine.query_engine import build_high_df_terms

        self._high_df_terms = build_high_df_terms(
            index.bm25, self.config.query_df_ratio_max, self._n)

    @property
    def n_shards(self) -> int:
        return self.mesh.shape[self.axis]

    # ---- host prep (shared helpers — same code as QueryEngine) ----

    def _bucket(self, b: int) -> int:
        from ..engine.query_engine import pick_bucket

        return pick_bucket(self.config.batch_buckets, b)

    def _encode_term_ids(self, variants: Sequence[Sequence[str]], E: int
                         ) -> np.ndarray:
        from ..engine.query_engine import encode_query_term_ids

        return encode_query_term_ids(
            variants, E, self.config.max_query_terms,
            self.index.bm25.vocab, self._native_vocab,
        )

    # ---- the sharded device program ----

    def _program(self, key: Tuple) -> Any:
        if key in self._jit_cache:
            return self._jit_cache[key]
        (B, E, T, S, pool_k, k, window, seeds_explicit) = key
        cfg = self.config
        n, n_pad, n_local = self._n, self._n_pad, self._n_local
        axis = self.axis
        n_shards = self.n_shards
        alphas = jnp.asarray(
            [cfg.alpha_text, cfg.alpha_graph, cfg.alpha_dense], jnp.float32)
        decay = jnp.asarray(hop_decay_table(max(window, 0)))
        topm = self._term_topm
        # graph formulation — mirrors QueryEngine's rule (fusion here is
        # always pool-compact, so only the buffer-size condition applies)
        if cfg.graph_impl not in ("auto", "dense", "compact"):
            raise ValueError(f"unknown graph_impl {cfg.graph_impl!r}")
        use_compact_graph = cfg.graph_impl == "compact" or (
            cfg.graph_impl == "auto" and B * n * 4 > 256 << 20)

        def merge_variant_shards(v_s, v_i, K):
            """all_gather each variant's per-shard pool ([b, E, K_local],
            global ids) -> the variant's top K over the corpus (replicated).

            A shard's top K holds every one of its docs in the corpus-wide
            top K, so this is the one-device selection. Ties resolve by
            ascending global id: shards concatenate in row order and each
            shard's pool is already (score desc, id asc)."""
            b_loc, E_loc, _ = v_s.shape  # dcn DP: local block, not the bucket
            all_s = jax.lax.all_gather(v_s, axis)  # [s, b, E, K_local]
            all_i = jax.lax.all_gather(v_i, axis)
            cat_s = jnp.moveaxis(all_s, 0, 2).reshape(b_loc, E_loc, -1)
            cat_i = jnp.moveaxis(all_i, 0, 2).reshape(b_loc, E_loc, -1)
            top_s, pos = jax.lax.top_k(cat_s, min(K, cat_s.shape[2]))
            return top_s, jnp.take_along_axis(cat_i, pos, axis=2)

        def local_fn(q_emb, term_ids, seed_rows, csr_ids, csr_sc, csr_rp,
                     emb_l, dt_l, ds_l, nbrs_l):
            # under composed (dcn, data) meshes the query batch is split
            # over the dcn axes, so every batch-shaped op below must use
            # the LOCAL block size, not the closure's global bucket
            B = q_emb.shape[0]  # noqa: F841 — shadows the key's global B
            sh = jax.lax.axis_index(axis).astype(jnp.int32)
            lo = sh * n_local

            # ---- text: the one-device phase-1 selection, per shard then
            # merged per variant; exact re-score where each id lives ----
            v_s, v_i = bm25_variant_pools(
                term_ids, csr_ids[0], csr_sc[0], csr_rp[0],
                n_docs=n_local, term_topm=topm, pool_k=min(pool_k, n_local),
            )
            v_i = jnp.where(v_i < n_local, v_i + lo, n)
            v_s, v_i = merge_variant_shards(
                v_s, v_i, min(pool_k, term_ids.shape[2] * topm))
            pool_s, pool_i = merge_variant_pools(v_s, v_i, n_docs=n,
                                                 pool_k=pool_k)
            pad = pool_k - pool_s.shape[1]
            if pad > 0:
                pool_i = jnp.pad(pool_i, ((0, 0), (0, pad)),
                                 constant_values=-1)
            owned = (pool_i >= lo) & (pool_i < lo + n_local)
            pool_s = jax.lax.psum(jnp.where(owned, bm25_rescore_pool(
                jnp.where(owned, pool_i - lo, -1), term_ids, dt_l, ds_l,
                n_docs=n_local), 0.0), axis)
            pool_s, pool_i = canonical_pool_order(pool_s, pool_i)
            pool_valid = (pool_s > 0) & (pool_i >= 0)

            # ---- dense: score owned pool ids locally, psum-assemble ----
            qn = q_emb / jnp.maximum(
                jnp.sqrt(jnp.sum(q_emb * q_emb, axis=1, keepdims=True)), 1e-9)
            owned = pool_valid & (pool_i >= lo) & (pool_i < lo + n_local)
            local_rows = jnp.where(owned, pool_i - lo, 0)
            pool_emb = jnp.take(emb_l, local_rows, axis=0)  # [B, P, d]
            dense = jnp.einsum("bd,bkd->bk", qn,
                               pool_emb.astype(jnp.float32),
                               precision=DENSE_PRECISION,
                               preferred_element_type=jnp.float32)
            dense_pool = jax.lax.psum(jnp.where(owned, dense, 0.0), axis)

            # ---- graph: compact N-independent path ----
            if use_compact_graph:
                # compact seeds, exactly as QueryEngine's compact branch
                if seeds_explicit:
                    c_seed_ids = seed_rows
                    c_seed_vals = (seed_rows >= 0).astype(jnp.float32)
                else:
                    S_eff = min(S, pool_k)
                    top_seed_s, seed_pos = jax.lax.top_k(pool_s, S_eff)
                    c_seed_ids = jnp.take_along_axis(pool_i, seed_pos, axis=1)
                    seed_ok = (top_seed_s > 0) & (c_seed_ids >= 0)
                    if cfg.graph_seed_weighted:
                        denom = jnp.maximum(top_seed_s[:, :1], 1e-9)
                        c_seed_vals = jnp.where(
                            seed_ok, top_seed_s / denom, 0.0)
                    else:
                        c_seed_vals = seed_ok.astype(jnp.float32)

                def gather_rows(src_ids):
                    # each wave node's adjacency row lives on exactly one
                    # shard: gather it there (non-owned slots -1) and
                    # rebuild the replicated [B, C, deg] rows with one
                    # pmax all-reduce (C*deg*4 bytes/query vs the dense
                    # path's n_local*deg*4 gather — N-independent).
                    owned = (src_ids >= lo) & (src_ids < lo + n_local)
                    local_rows = jnp.where(owned, src_ids - lo, 0)
                    rows_l = jnp.take(nbrs_l, local_rows, axis=0)
                    rows_l = jnp.where(owned[:, :, None], rows_l, -1)
                    return jax.lax.pmax(rows_l, axis)

                P_g = min(pool_k, n)
                g_pool_s, g_pool_i = expand_frontier_weighted_compact_core(
                    gather_rows, c_seed_ids, c_seed_vals, n_nodes=n,
                    window=window, cap=cfg.graph_compact_cap, out_k=P_g)
                g_valid = (g_pool_s > 0) & (g_pool_i >= 0)
                counts = jnp.stack(
                    [jnp.sum(pool_valid, axis=1), jnp.sum(g_valid, axis=1),
                     jnp.sum(pool_valid, axis=1)], axis=1)
                # graph value at text-pool ids = membership lookup in the
                # graph pool (same sufficient-statistic trick as the
                # single-chip compact branch)
                eq = pool_i[:, :, None] == jnp.where(
                    g_valid, g_pool_i, -2)[:, None, :]
                t_graph_raw = jnp.max(
                    jnp.where(eq, g_pool_s[:, None, :], 0.0), axis=2)
                top_s, top_i, norms_at = fuse_pools_compact(
                    pool_s, pool_i, pool_valid, dense_pool, t_graph_raw,
                    g_pool_s, g_pool_i, g_valid, alphas=alphas, k=k, n=n,
                )
                if cfg.order_alphas is not None:
                    top_s, top_i, norms_at = reorder_hits(
                        top_s, top_i, norms_at, cfg.order_alphas)
                f32_pack = jnp.concatenate(
                    [top_s, norms_at.reshape(B, -1)], axis=1)
                i32_pack = jnp.concatenate(
                    [top_i.astype(jnp.int32), counts.astype(jnp.int32)],
                    axis=1)
                return f32_pack, i32_pack

            # ---- graph: seed wave, sharded gather-max per hop ----
            if seeds_explicit:
                rows_s = jnp.broadcast_to(jnp.arange(B)[:, None], (B, S))
                seed_ok = seed_rows >= 0
                seed_vals = jnp.where(seed_ok, 1.0, 0.0)
                seed_dst = jnp.where(seed_ok, seed_rows, n_pad)
            else:
                S_eff = min(S, pool_k)
                top_seed_s, seed_pos = jax.lax.top_k(pool_s, S_eff)
                top_seed_i = jnp.take_along_axis(pool_i, seed_pos, axis=1)
                rows_s = jnp.broadcast_to(jnp.arange(B)[:, None], (B, S_eff))
                seed_ok = (top_seed_s > 0) & (top_seed_i >= 0)
                if cfg.graph_seed_weighted:
                    denom = jnp.maximum(top_seed_s[:, :1], 1e-9)
                    seed_vals = jnp.where(seed_ok, top_seed_s / denom, 0.0)
                else:
                    seed_vals = jnp.where(seed_ok, 1.0, 0.0)
                seed_dst = jnp.where(seed_ok, top_seed_i, n_pad)
            wave = (
                jnp.zeros((B, n_pad + 1), dtype=jnp.float32)
                .at[rows_s, seed_dst]
                .max(seed_vals)[:, :n_pad]
            )  # replicated [B, n_pad]

            safe_nbrs = jnp.where(nbrs_l >= 0, nbrs_l, 0)  # [n_local, deg]
            has_nbr = nbrs_l >= 0
            best = wave * decay[0]  # hop 0 keeps full seed precision
            # graph_wave_dtype="bfloat16" rounds the wave at the SAME points
            # as the single-chip batched formulation (cast once before the
            # hops; maxes in wdt), so both paths stay bit-for-bit — and the
            # per-hop all_gather moves half the bytes
            wdt = jnp.dtype(cfg.graph_wave_dtype)
            wave = wave.astype(wdt)
            for h in range(1, max(window, 0) + 1):
                gathered = jnp.where(
                    has_nbr[None], wave[:, safe_nbrs.reshape(-1)].reshape(
                        B, n_local, -1), jnp.array(0, wdt))
                new_local = jnp.max(gathered, axis=2)  # [B, n_local]
                allw = jax.lax.all_gather(new_local, axis)  # [s, B, n_local]
                wave = jnp.moveaxis(allw, 0, 1).reshape(B, n_pad)
                best = jnp.maximum(best, wave.astype(jnp.float32) * decay[h])

            P_g = min(pool_k, n_pad)
            g_pool_s, g_pool_i = jax.lax.top_k(best, P_g)
            g_valid = (g_pool_s > 0) & (g_pool_i < n)
            t_graph_raw = jnp.take_along_axis(
                best, jnp.clip(pool_i, 0, n_pad - 1), axis=1)

            counts = jnp.stack(
                [jnp.sum(pool_valid, axis=1), jnp.sum(g_valid, axis=1),
                 jnp.sum(pool_valid, axis=1)], axis=1)

            top_s, top_i, norms_at = fuse_pools_compact(
                pool_s, pool_i, pool_valid, dense_pool, t_graph_raw,
                g_pool_s, g_pool_i, g_valid, alphas=alphas, k=k, n=n,
            )
            if cfg.order_alphas is not None:
                top_s, top_i, norms_at = reorder_hits(
                    top_s, top_i, norms_at, cfg.order_alphas)
            f32_pack = jnp.concatenate([top_s, norms_at.reshape(B, -1)],
                                       axis=1)
            i32_pack = jnp.concatenate(
                [top_i.astype(jnp.int32), counts.astype(jnp.int32)], axis=1)
            return f32_pack, i32_pack

        rowspec = P(self.axis, None)
        # query-batch tensors split over the dcn DP axes (batch dim 0);
        # with no dcn axes this degrades to fully-replicated P()
        qspec = P(self.dp_axes) if self.dp_axes else P()
        fn = jax.jit(
            jax.shard_map(
                local_fn,
                mesh=self.mesh,
                in_specs=(qspec, qspec, qspec, rowspec, rowspec, rowspec,
                          rowspec, rowspec, rowspec, rowspec),
                out_specs=(qspec, qspec),
                # outputs are value-replicated after the merges but carry an
                # axis_index taint the static checker can't discharge
                check_vma=False,
            )
        )
        self._jit_cache[key] = fn
        return fn

    # ---- public API (mirrors QueryEngine.query_batch) ----

    def query_batch(self, queries: Sequence[str], **kw) -> QueryResult:
        """Synchronous query: dispatch + fetch in one call."""
        pending = self.query_batch_async(queries, **kw)
        pending._sync_timing = True
        return pending.result()

    def query_batches_pipelined(self, batches: Sequence[Sequence[str]], **kw):
        """Prep-ahead pipelining (same contract + threading discipline as
        QueryEngine.query_batches_pipelined): a worker thread preps and
        dispatches batch i+1 while the caller blocks fetching batch i."""
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
    ) -> "Any":
        """Dispatch the sharded program without blocking on the fetch.

        ``prepruned=True``: the caller already applied ``prune_query``
        (native hop-2 bridge emission) — skip the re-prune.
        ``pool_k`` overrides ``cfg.pool_k`` for this dispatch, with
        `QueryEngine.query_batch_async`'s semantics (the iterative
        mode's hop-2 program rides it)."""
        from ..engine.query_engine import PendingQuery

        cfg = self.config
        B_real = len(queries)
        if self._n == 0 or B_real == 0:
            kk = top_k or cfg.top_k
            empty = HitBatch(ids=np.full((B_real, kk), -1, np.int32),
                             scores=np.zeros((B_real, kk), np.float32))
            return PendingQuery(done=QueryResult(
                hits=empty,
                channel_norms=np.zeros((3, B_real, kk)),
                diagnostics={"empty_index": self._n == 0}))

        k = min(int(top_k or cfg.top_k), self._n)
        window = (cfg.graph_window if graph_window is None
                  else max(0, int(graph_window)))
        pool_k = min(int(pool_k or cfg.pool_k), self._n)
        pool_k = max(pool_k, k)  # the pool must at least cover the output
        B = self._bucket(B_real)
        if B % self._dp_size:
            # dcn DP splits the batch dim across groups — pad the bucket up
            B = -(-B // self._dp_size) * self._dp_size

        from ..engine.query_engine import (prepare_query_variants,
                                           trim_term_bucket)

        if self._high_df_terms and not prepruned:
            from ..engine.query_engine import prune_query

            queries = [prune_query(q, self._high_df_terms) for q in queries]
            if expansions is not None:
                expansions = [[prune_query(e, self._high_df_terms)
                               for e in ex] for ex in expansions]
        variants, E = prepare_query_variants(queries, expansions, B,
                                             cfg.qe_variants)
        originals = [v[0] if v else "" for v in variants]
        q_emb = np.asarray(self.encoder.encode_texts(originals),
                           dtype=np.float32)
        term_ids = self._encode_term_ids(variants, E)
        term_ids = trim_term_bucket(term_ids, cfg.max_query_terms)
        T_eff = term_ids.shape[2]

        seeds_explicit = seed_rows is not None
        S = cfg.max_seed_rows
        seed_arr = np.full((B, S), -1, dtype=np.int32)
        if seeds_explicit:
            for i in range(min(B_real, B)):
                rows = list(seed_rows[i])[:S]
                seed_arr[i, : len(rows)] = rows

        key = (B, E, T_eff, S, pool_k, k, window, seeds_explicit)
        fn = self._program(key)
        a = self._arr
        t0 = time.time()
        f32_pack, i32_pack = fn(
            jnp.asarray(q_emb), jnp.asarray(term_ids), jnp.asarray(seed_arr),
            a["csr_doc_ids"], a["csr_scores"], a["csr_row_ptr"],
            a["emb"], a["doc_terms"], a["doc_scores"], a["nbrs"],
        )
        return _ShardedPending(
            engine=self, f32_pack=f32_pack, i32_pack=i32_pack, B=B,
            B_real=B_real, k=k, pool_k=pool_k, window=window, t0=t0,
            trace_id=trace_id, n_shards=self.n_shards,
        )

    def hydrate_hits(self, result: QueryResult, row: int,
                     extra_meta: Optional[Dict[str, Any]] = None):
        from ..engine.query_engine import hydrate_result_hits

        return hydrate_result_hits(self.index.corpus, result, row, extra_meta)


class _ShardedPending:
    """PendingQuery wrapper adding the shard count to diagnostics."""

    def __init__(self, *, n_shards: int, **kw):
        from ..engine.query_engine import PendingQuery

        self._inner = PendingQuery(**kw)
        self._n_shards = n_shards

    @property
    def _sync_timing(self):
        return self._inner._sync_timing

    @_sync_timing.setter
    def _sync_timing(self, v):
        self._inner._sync_timing = v

    def result(self) -> QueryResult:
        r = self._inner.result()
        r.diagnostics["n_shards"] = self._n_shards
        return r


def _tie_free_corpus(n_docs: int = 40, seed: int = 11):
    """Random distinct-length sentences: BM25/dense/graph scores carry no
    exact tie groups, so pool membership is deterministic and the
    single-chip and sharded engines must agree bit-for-bit. (Template-heavy
    corpora create large exact-tie groups at pool boundaries where the two
    selection orders legitimately pick different — equally-scored —
    members; see the module docstring.)"""
    import random

    from ..index.corpus import SentenceCorpus

    rng = random.Random(seed)
    words = [f"w{chr(97 + i % 26)}{i}" for i in range(160)]
    docs = []
    for di in range(n_docs):
        title = f"Doc {di}"
        for si in range(rng.randrange(2, 6)):
            n_tok = rng.randrange(4, 14)
            text = " ".join(rng.choice(words) for _ in range(n_tok))
            docs.append({"doc_id": f"{title}#{si}", "title": title,
                         "sent_id": si, "text": text})
    queries = []
    for _ in range(8):
        queries.append(" ".join(rng.choice(words)
                                for _ in range(rng.randrange(3, 7))))
    return SentenceCorpus(docs=docs), queries


def dryrun_check(mesh: Mesh) -> None:
    """Driver-contract check: sharded hybrid == single-chip engine.

    Runs both engines over a tie-free corpus with exact settings
    (term_topm covering every posting list) and asserts identical ids and
    scores, in both derived-seed and explicit-seed modes. Called from
    ``__graft_entry__._dryrun_impl`` and tests/test_sharded_hybrid.py.
    """
    from ..engine.query_engine import QueryEngine
    from ..index.builder import build_packed_index

    corpus, queries = _tie_free_corpus()
    idx = build_packed_index(corpus, embed_dim=32, embed_dtype="float32")
    # the 4th case runs two-stage fusion (graph-heavy selection +
    # parity-ordered re-rank) — the bench's production configuration —
    # through the same bit-for-bit contract
    for graph_impl, wave_dtype, order in (("dense", "float32", None),
                                          ("compact", "float32", None),
                                          ("dense", "bfloat16", None),
                                          ("compact", "float32",
                                           (0.4, 0.2, 0.4))):
        kw = dict(top_k=10, pool_k=64, graph_window=2,
                  bm25_term_topm=4096, batch_buckets=(8,),
                  graph_pool_exact=True, graph_impl=graph_impl,
                  graph_compact_cap=64, graph_wave_dtype=wave_dtype)
        if order:
            kw.update(alpha_text=0.15, alpha_graph=0.7, alpha_dense=0.15,
                      order_alphas=order)
        cfg = EngineConfig(**kw)
        single = QueryEngine(idx, config=cfg)
        sharded = ShardedHybridEngine(idx, mesh=mesh, config=cfg)

        def check(kw, mode):
            r1 = single.query_batch(queries, top_k=10, **kw)
            r2 = sharded.query_batch(queries, top_k=10, **kw)
            if not np.array_equal(np.asarray(r1.hits.ids),
                                  np.asarray(r2.hits.ids)):
                raise RuntimeError(
                    f"sharded hybrid ids diverge from single-chip "
                    f"({mode}, graph_impl={graph_impl})")
            if not np.allclose(np.asarray(r1.hits.scores),
                               np.asarray(r2.hits.scores), atol=1e-5):
                raise RuntimeError(
                    f"sharded hybrid scores diverge from single-chip "
                    f"({mode}, graph_impl={graph_impl})")

        check({}, "derived seeds")
        seeds = [[(3 * i) % idx.n_docs, (7 * i + 1) % idx.n_docs]
                 for i in range(len(queries))]
        check({"seed_rows": seeds}, "explicit seeds")
