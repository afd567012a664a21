"""Query engine vs a host oracle that mirrors the reference hybrid fusion,
plus sharded dense retrieval on the 8-device CPU mesh."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from a_modular_rag_framework_tpu.core.dataset_loader import SyntheticHotpotQALoader
from a_modular_rag_framework_tpu.engine.query_engine import EngineConfig, QueryEngine
from a_modular_rag_framework_tpu.index.builder import build_packed_index
from a_modular_rag_framework_tpu.index.corpus import SentenceCorpus
from a_modular_rag_framework_tpu.models.hash_embed import hash_embed_numpy, tokenize
from a_modular_rag_framework_tpu.parallel.mesh import build_mesh
from a_modular_rag_framework_tpu.parallel.sharded import shard_corpus_rows, sharded_dense_topk


@pytest.fixture(scope="module")
def packed():
    samples = SyntheticHotpotQALoader({"count": 20, "seed": 5}).load()
    corpus = SentenceCorpus.from_hotpotqa(samples)
    # reference-formula parity fixture: phrase-token augmentation off
    # (the oracle below scores plain tokens; the augmentation is our
    # extension and has its own test)
    return build_packed_index(corpus, embed_dim=64, embed_dtype="float32",
                              bm25_phrase_tokens=False), samples


def hybrid_oracle(corpus_texts, query, variants, seeds, window, pool_k, k,
                  alphas=(0.4, 0.2, 0.4), nbrs=None):
    """Host reimplementation of the engine semantics (reference fusion rules)."""
    from a_modular_rag_framework_tpu.eval.host_reference import bm25_oracle
    from tests.test_ops import bfs_decay_oracle

    n = len(corpus_texts)
    text = bm25_oracle(corpus_texts, variants, merge="max")
    order = np.argsort(-text, kind="stable")
    pool = [i for i in order[:pool_k] if text[i] > 0]

    emb = hash_embed_numpy(corpus_texts, dim=64)
    q = hash_embed_numpy([query], dim=64)[0]
    dense = np.zeros(n)
    for i in pool:
        denom = np.linalg.norm(q) * np.linalg.norm(emb[i])
        dense[i] = float(q @ emb[i] / denom) if denom else 0.0

    edges = []
    if nbrs is not None:
        for a in range(n):
            for b in nbrs[a]:
                if b >= 0:
                    edges.append((a, int(b)))
    graph = bfs_decay_oracle(n, edges, seeds, window) if seeds else np.zeros(n)
    g_order = np.argsort(-graph, kind="stable")
    g_pool = [i for i in g_order[:pool_k] if graph[i] > 0]

    def norm(vals, present):
        if not present:
            return np.zeros(n)
        vs = [vals[i] for i in present]
        lo, hi = min(vs), max(vs)
        out = np.zeros(n)
        if hi <= lo:
            return out
        for i in present:
            out[i] = (vals[i] - lo) / (hi - lo)
        return out

    nt, ng, nd = norm(text, pool), norm(graph, g_pool), norm(dense, pool)
    union = sorted(set(pool) | set(g_pool))
    fused = {i: alphas[0] * nt[i] + alphas[1] * ng[i] + alphas[2] * nd[i] for i in union}
    ranked = sorted(fused.items(), key=lambda kv: -kv[1])[:k]
    return ranked, (nt, ng, nd)


def test_engine_matches_hybrid_oracle(packed):
    idx, samples = packed
    # scatter impl: shares the oracle's exact tie ordering (the synthetic
    # corpus has large score ties at the pool boundary; the sorted impl
    # resolves them differently — covered by its own test below)
    engine = QueryEngine(
        idx,
        config=EngineConfig(top_k=10, pool_k=50, graph_window=2,
                            include_entity_graph=False, batch_buckets=(1, 4),
                            bm25_impl="scatter"),
    )
    q = samples[0]["question"]
    variants = [q, " ".join(tokenize(q)[:4])]
    seeds = engine.qmatch_seed_rows(q, range(min(len(idx.corpus), 200)))[:32]

    res = engine.query_batch([q], expansions=[variants[1:]], seed_rows=[seeds])
    got_ids = np.asarray(res.hits.ids)[0]
    got_scores = np.asarray(res.hits.scores)[0]

    ranked, _ = hybrid_oracle(
        idx.corpus.texts(), q, variants, seeds, window=2, pool_k=50, k=10,
        nbrs=idx.graph_next,
    )
    want_ids = [i for i, _ in ranked]
    want_scores = [s for _, s in ranked]
    got_valid = [int(i) for i in got_ids if i >= 0][: len(want_ids)]
    # scores must match (id order may differ within score ties)
    np.testing.assert_allclose(got_scores[: len(want_scores)], want_scores, atol=2e-3)
    overlap = len(set(got_valid) & set(want_ids)) / max(1, len(want_ids))
    assert overlap >= 0.9, (got_valid, want_ids)


def _sf_recall(idx, samples, cfg):
    engine = QueryEngine(idx, config=cfg)
    by = idx.corpus.row_by_title_sid()
    hit, total = 0, 0
    for s in samples:
        res = engine.query_batch([s["question"]])
        got = set(int(i) for i in np.asarray(res.hits.ids)[0] if i >= 0)
        for t, sid in s["supporting_facts"]:
            row = by.get((t, sid))
            if row is None:
                continue
            total += 1
            hit += int(row in got)
    return hit, total


def test_sorted_bm25_pipeline_scores_exact(packed):
    """The production (sorted two-phase) BM25: every returned pool doc's
    score must equal the exact dense computation; membership may differ from
    the scatter path only within score ties."""
    import jax.numpy as jnp

    from a_modular_rag_framework_tpu.ops.bm25 import (
        bm25_rescore_pool,
        bm25_scores_batched,
        bm25_topk_sorted,
    )

    idx, samples = packed
    dev = idx.bm25.device_arrays()
    n = idx.n_docs
    engine = QueryEngine(idx, config=EngineConfig(batch_buckets=(4,)))
    _, term_ids = engine.encode_queries(
        [[s["question"]] for s in samples[:4]], n_variants=1
    )
    tid = jnp.asarray(term_ids)
    dense = np.asarray(bm25_scores_batched(
        tid, dev["doc_ids"], dev["scores"], dev["row_ptr"],
        n_docs=n, cap=4096, merge="max"))
    ps, pd = bm25_topk_sorted(tid, dev["doc_ids"], dev["scores"],
                              dev["row_ptr"], n_docs=n, term_topm=1024,
                              pool_k=50)
    rs = np.asarray(bm25_rescore_pool(pd, tid, dev["doc_terms_padded"],
                                      dev["doc_scores_padded"], n_docs=n))
    ps, pd = np.asarray(ps), np.asarray(pd)
    # the windows hold every posting here, so phase-1's run totals are the
    # exact re-score bit for bit: the pool a row selects cannot depend on
    # the other docs in the row (a shard's row vs the whole corpus's)
    np.testing.assert_array_equal(ps[pd >= 0], rs[pd >= 0])
    for b in range(4):
        for phase1, exact, d in zip(ps[b], rs[b], pd[b]):
            if d >= 0:
                np.testing.assert_allclose(phase1, dense[b, d], rtol=1e-4)
                np.testing.assert_allclose(exact, dense[b, d], rtol=1e-4)
        # membership: every pool doc scores >= the (tie-tolerant) cutoff
        valid = pd[b] >= 0
        if valid.any():
            cutoff = np.sort(dense[b][dense[b] > 0])[::-1][: valid.sum()][-1]
            assert (dense[b, pd[b][valid]] >= cutoff - 1e-4).all()


def test_sorted_bm25_packed_gather_bit_identical(packed):
    """posting_packed (one interleaved 8-byte gather) must return exactly
    the same pool as the two-array gather path."""
    import jax.numpy as jnp

    from a_modular_rag_framework_tpu.ops.bm25 import bm25_topk_sorted

    idx, samples = packed
    dev = idx.bm25.device_arrays(packed_postings=True)
    assert "posting_packed" in dev
    n = idx.n_docs
    engine = QueryEngine(idx, config=EngineConfig(batch_buckets=(4,)))
    _, term_ids = engine.encode_queries(
        [[s["question"]] for s in samples[:4]], n_variants=1
    )
    tid = jnp.asarray(term_ids)
    ps1, pd1 = bm25_topk_sorted(tid, dev["doc_ids"], dev["scores"],
                                dev["row_ptr"], n_docs=n, term_topm=16,
                                pool_k=50)
    ps2, pd2 = bm25_topk_sorted(tid, dev["doc_ids"], dev["scores"],
                                dev["row_ptr"], n_docs=n, term_topm=16,
                                pool_k=50,
                                posting_packed=dev["posting_packed"])
    np.testing.assert_array_equal(np.asarray(pd1), np.asarray(pd2))
    np.testing.assert_array_equal(np.asarray(ps1), np.asarray(ps2))


def test_dense_matmul_impl_matches_pool_scores(packed):
    """dense_impl='matmul' must produce the same dense-channel VALUES as
    the pool-gather formulation (within f32 accumulation tolerance), and
    near-identical final rankings on a tie-free query set."""
    idx, samples = packed
    qs = [s["question"] for s in samples[:8]]
    base = dict(top_k=10, pool_k=64, graph_window=2, bm25_term_topm=4096,
                batch_buckets=(8,), graph_wave_dtype="float32")
    e_p = QueryEngine(idx, config=EngineConfig(dense_impl="pool", **base))
    e_m = QueryEngine(idx, config=EngineConfig(dense_impl="matmul", **base))
    r_p = e_p.query_batch(qs)
    r_m = e_m.query_batch(qs)
    np.testing.assert_allclose(np.asarray(r_m.hits.scores),
                               np.asarray(r_p.hits.scores), atol=1e-5)
    # rankings agree except where adjacent scores are within tolerance
    ids_p, ids_m = np.asarray(r_p.hits.ids), np.asarray(r_m.hits.ids)
    s_p = np.asarray(r_p.hits.scores)
    for b in range(ids_p.shape[0]):
        for k in range(ids_p.shape[1]):
            if ids_p[b, k] != ids_m[b, k]:
                close = np.abs(s_p[b] - s_p[b, k]) < 1e-5
                assert close.sum() > 1, (b, k)


def test_dense_matmul_rejected_with_compact_graph(packed):
    idx, samples = packed
    eng = QueryEngine(idx, config=EngineConfig(
        dense_impl="matmul", graph_impl="compact", batch_buckets=(4,),
        graph_compact_cap=64))
    with pytest.raises(ValueError, match="compact"):
        eng.query_batch([s["question"] for s in samples[:4]])


def test_engine_retrieves_supporting_facts(packed):
    """Recall sanity on an adversarial synthetic corpus (name-collision
    distractors): hybrid with weighted graph expansion must not lose to
    BM25-only, and must find at least half the supporting facts single-shot
    (the verify-retry loop handles the rest at the pipeline level)."""
    idx, samples = packed
    hit, total = _sf_recall(
        idx, samples[:16],
        EngineConfig(top_k=20, pool_k=100, graph_window=2, batch_buckets=(1, 8)),
    )
    hit_bm25, _ = _sf_recall(
        idx, samples[:16],
        EngineConfig(top_k=20, pool_k=100, graph_window=0, alpha_graph=0.0,
                     batch_buckets=(1, 8)),
    )
    assert total > 0
    assert hit >= hit_bm25, f"hybrid {hit} < bm25-only {hit_bm25}"
    assert hit / total >= 0.5, f"supporting-fact recall {hit}/{total}"


def test_engine_batching_and_padding(packed):
    idx, _ = packed
    engine = QueryEngine(idx, config=EngineConfig(top_k=5, pool_k=20,
                                                     batch_buckets=(4,)))
    res = engine.query_batch(["Alden", "Brisa", "Corin"])  # B=3 -> bucket 4
    assert res.hits.ids.shape == (3, 5)
    assert res.diagnostics["batch_bucket"] == 4


def test_engine_empty_query_and_empty_index(packed):
    idx, _ = packed
    engine = QueryEngine(idx, config=EngineConfig(batch_buckets=(1,)))
    res = engine.query_batch([""])
    assert (np.asarray(res.hits.ids) == -1).all() or res.hits.ids.shape[0] == 1

    empty_idx = build_packed_index(SentenceCorpus(docs=[]), embed_dim=8)
    engine2 = QueryEngine(empty_idx)
    res2 = engine2.query_batch(["anything"])
    assert res2.diagnostics.get("empty_index") is True
    assert (np.asarray(res2.hits.ids) == -1).all()


def test_engine_hydration(packed):
    idx, samples = packed
    engine = QueryEngine(idx, config=EngineConfig(top_k=5, batch_buckets=(1,)))
    res = engine.query_batch([samples[0]["question"]])
    hits = engine.hydrate_hits(res, 0, extra_meta={"source": "engine"})
    assert hits and hits[0].id.startswith("sent::")
    m = hits[0].meta
    assert {"score_text_norm", "score_graph_norm", "score_dense_norm",
            "text", "doc", "sent_id", "source"} <= set(m)
    assert m["source"] == "engine"


# ---------------- sharded dense (8-device CPU mesh) ----------------


def test_sharded_dense_topk_matches_single_device(rng):
    mesh = build_mesh({"data": -1})
    n_dev = mesh.devices.size
    assert n_dev == 8  # conftest forces 8 virtual CPU devices
    N, d, B, k = 1024, 32, 4, 10
    emb = rng.standard_normal((N, d)).astype(np.float32)
    q = rng.standard_normal((B, d)).astype(np.float32)

    emb_sharded = shard_corpus_rows(jnp.asarray(emb), mesh)
    s_sh, i_sh = sharded_dense_topk(jnp.asarray(q), emb_sharded, k, mesh,
                                    precision=jax.lax.Precision.HIGHEST)
    ref = q @ emb.T
    want_ids = np.argsort(-ref, axis=1)[:, :k]
    np.testing.assert_allclose(
        np.asarray(s_sh), np.take_along_axis(ref, want_ids, 1), rtol=1e-5
    )
    np.testing.assert_array_equal(np.asarray(i_sh), want_ids)


def test_build_mesh_shapes():
    m = build_mesh({"data": 4, "model": 2})
    assert m.shape == {"data": 4, "model": 2}
    m2 = build_mesh({"data": -1, "model": 2})
    assert m2.shape["model"] == 2 and m2.shape["data"] == 4
    with pytest.raises(ValueError):
        build_mesh({"data": 3})


def test_dense_only_query(packed):
    """Pure-dense brute-force retrieval over the full corpus (config 2)."""
    idx, samples = packed
    engine = QueryEngine(idx, config=EngineConfig(top_k=5, batch_buckets=(1, 4)))
    res = engine.query_dense_batch([samples[0]["question"]], top_k=5)
    ids = np.asarray(res.hits.ids)[0]
    scores = np.asarray(res.hits.scores)[0]
    assert (ids >= 0).all() and res.diagnostics["mode"] == "dense_only"
    # matches the brute-force numpy cosine
    emb = hash_embed_numpy(idx.corpus.texts(), dim=64)
    q = hash_embed_numpy([samples[0]["question"]], dim=64)[0]
    norms = np.linalg.norm(emb, axis=1) * np.linalg.norm(q)
    sims = np.where(norms > 0, emb @ q / np.maximum(norms, 1e-9), 0.0)
    want = np.argsort(-sims, kind="stable")[:5]
    assert set(ids.tolist()) <= set(np.argsort(-sims)[:20].tolist())
    np.testing.assert_allclose(scores, np.sort(sims)[::-1][:5], atol=2e-2)


def test_sharded_dense_engine_matches_single_chip(packed):
    """Multi-chip dense serving over the 8-device CPU mesh."""
    from a_modular_rag_framework_tpu.parallel.sharded_engine import ShardedDenseEngine

    idx, samples = packed
    sharded = ShardedDenseEngine(idx, batch_buckets=(4,))
    assert sharded.n_shards == 8
    single = QueryEngine(idx, config=EngineConfig(batch_buckets=(4,)))
    qs = [s["question"] for s in samples[:3]]
    hb = sharded.query_batch(qs, top_k=7)
    rd = single.query_dense_batch(qs, top_k=7)
    # same candidates and scores as the single-device dense path
    np.testing.assert_allclose(np.asarray(hb.scores),
                               np.asarray(rd.hits.scores), atol=2e-2)
    for b in range(3):
        a = set(int(x) for x in np.asarray(hb.ids)[b])
        c = set(int(x) for x in np.asarray(rd.hits.ids)[b])
        assert len(a & c) >= 5  # ties at the boundary may swap


def test_long_query_term_truncation(packed):
    """Queries longer than max_query_terms truncate cleanly (T bucketing)."""
    idx, samples = packed
    engine = QueryEngine(idx, config=EngineConfig(top_k=5, max_query_terms=32,
                                                     batch_buckets=(1,)))
    long_q = " ".join(tokenize(samples[0]["question"]) * 10)  # ~80 terms
    res = engine.query_batch([long_q])
    assert np.asarray(res.hits.ids).shape == (1, 5)
    assert (np.asarray(res.hits.ids) >= -1).all()


def test_query_df_pruning(tmp_path):
    """IDF-guided query pruning: high-df tokens drop, rare ones stay, and
    a query of only high-df tokens falls back to the original."""
    from a_modular_rag_framework_tpu.core.dataset_loader import SyntheticHotpotQALoader
    from a_modular_rag_framework_tpu.engine.query_engine import EngineConfig, QueryEngine
    from a_modular_rag_framework_tpu.index.builder import build_packed_index
    from a_modular_rag_framework_tpu.index.corpus import SentenceCorpus

    samples = SyntheticHotpotQALoader({"count": 40, "seed": 3,
                                       "unique_entities": True}).load()
    idx = build_packed_index(SentenceCorpus.from_hotpotqa(samples),
                             embed_dim=32, embed_dtype="float32")
    engine = QueryEngine(idx, config=EngineConfig(
        top_k=5, pool_k=32, graph_window=1, batch_buckets=(8,),
        query_df_ratio_max=0.05))
    assert engine._high_df_terms and "born" in engine._high_df_terms
    q = samples[0]["question"]
    pruned = engine._prune_query(q)
    assert "born" not in pruned.split()
    assert len(pruned.split()) >= 1
    # all-high-df query falls back unchanged
    assert engine._prune_query("was born in") == "was born in"
    # the engine still answers and pruning does not crash the pipeline
    r = engine.query_batch([q], top_k=5)
    assert (r.hits.ids >= 0).any()

    off = QueryEngine(idx, config=EngineConfig(
        top_k=5, pool_k=32, graph_window=1, batch_buckets=(8,)))
    assert off._high_df_terms is None
    assert off._prune_query(q) == q


def test_graph_impl_compact_matches_dense_both_seed_modes():
    """The N-independent compact graph channel == the dense [B, N] one on a
    tie-free corpus, in derived-seed and explicit-seed modes (ids AND
    scores). Compact is the scale path (no [B, N] buffer in the program);
    dense is the oracle."""
    samples = SyntheticHotpotQALoader({"count": 24, "seed": 5,
                                       "unique_entities": True}).load()
    corpus = SentenceCorpus.from_hotpotqa(samples)
    idx = build_packed_index(corpus, embed_dim=32, embed_dtype="float32")
    qs = [s["question"] for s in samples]
    # float32 waves: dense and compact round bf16 at different points, so
    # the bit/1e-5 oracle comparison requires the exact dtype (the shipped
    # default is bfloat16 — see EngineConfig.graph_wave_dtype)
    base = dict(top_k=10, pool_k=64, graph_window=2, bm25_term_topm=4096,
                batch_buckets=(32,), graph_wave_dtype="float32")
    e_d = QueryEngine(idx, config=EngineConfig(graph_impl="dense", **base))
    e_c = QueryEngine(idx, config=EngineConfig(
        graph_impl="compact", graph_compact_cap=2048, **base))

    r_d = e_d.query_batch(qs, top_k=10)
    r_c = e_c.query_batch(qs, top_k=10)
    np.testing.assert_array_equal(np.asarray(r_d.hits.ids),
                                  np.asarray(r_c.hits.ids))
    np.testing.assert_allclose(np.asarray(r_d.hits.scores),
                               np.asarray(r_c.hits.scores), atol=1e-5)

    # explicit q_match-style seeds (parity mode)
    seeds = [[int(i) for i in np.asarray(r_d.hits.ids)[row][:4] if i >= 0]
             for row in range(len(qs))]
    r_ds = e_d.query_batch(qs, seed_rows=seeds, top_k=10)
    r_cs = e_c.query_batch(qs, seed_rows=seeds, top_k=10)
    np.testing.assert_array_equal(np.asarray(r_ds.hits.ids),
                                  np.asarray(r_cs.hits.ids))
    np.testing.assert_allclose(np.asarray(r_ds.hits.scores),
                               np.asarray(r_cs.hits.scores), atol=1e-5)


def test_graph_impl_compact_requires_compact_fusion(packed):
    idx, _ = packed
    eng = QueryEngine(idx, config=EngineConfig(
        graph_impl="compact", fusion_impl="dense", batch_buckets=(8,)))
    with pytest.raises(ValueError, match="compact"):
        eng.query_batch(["anything"])


def test_order_alphas_validated_at_construction():
    import pytest as _pytest

    from a_modular_rag_framework_tpu.engine.query_engine import EngineConfig

    with _pytest.raises(ValueError, match="order_alphas"):
        EngineConfig(order_alphas=(0.4, 0.2))
    cfg = EngineConfig(order_alphas=[0.4, 0.2, 0.4])  # list normalizes
    assert cfg.order_alphas == (0.4, 0.2, 0.4)
