"""Sharded hybrid engine: all three channels sharded over the data axis.

VERDICT r1 item 4: BM25 CSR rows and graph adjacency sharded alongside
embeddings, per-shard channel scoring + global top-k merge, and the
documented `mesh:` config actually activating it.
"""
import numpy as np
import pytest

from a_modular_rag_framework_tpu.core.dataset_loader import SyntheticHotpotQALoader
from a_modular_rag_framework_tpu.engine.query_engine import EngineConfig, QueryEngine
from a_modular_rag_framework_tpu.index.builder import build_packed_index
from a_modular_rag_framework_tpu.index.corpus import SentenceCorpus
from a_modular_rag_framework_tpu.parallel.mesh import build_mesh
from a_modular_rag_framework_tpu.parallel.sharded_hybrid import (
    ShardedHybridEngine,
    dryrun_check,
)


def test_sharded_hybrid_bit_exact_both_seed_modes():
    """Tie-free corpus: sharded == single-chip on ids and scores, in both
    derived-seed and explicit-seed modes (the dryrun contract)."""
    dryrun_check(build_mesh({"data": 8}))


def test_sharded_hybrid_recall_equal_on_template_corpus():
    """Template corpora carry exact-tie groups at pool boundaries where the
    two selection orders may pick different equally-scored members; the
    semantic outcome (gold recall) must still match."""
    from a_modular_rag_framework_tpu.eval.harness import gold_hit_ids
    from a_modular_rag_framework_tpu.eval.metrics import recall_at_k

    samples = SyntheticHotpotQALoader({"count": 24, "seed": 5,
                                       "unique_entities": True}).load()
    corpus = SentenceCorpus.from_hotpotqa(samples)
    idx = build_packed_index(corpus, embed_dim=32, embed_dtype="float32")
    cfg = EngineConfig(top_k=10, pool_k=64, graph_window=2,
                       bm25_term_topm=4096, batch_buckets=(32,))
    single = QueryEngine(idx, config=cfg)
    sharded = ShardedHybridEngine(idx, mesh=build_mesh({"data": 8}),
                                  config=cfg)
    qs = [s["question"] for s in samples]
    r1 = single.query_batch(qs, top_k=10)
    r2 = sharded.query_batch(qs, top_k=10)
    i1, i2 = np.asarray(r1.hits.ids), np.asarray(r2.hits.ids)
    rec1, rec2 = [], []
    for row, s in enumerate(samples):
        gold = gold_hit_ids(s)
        rec1.append(recall_at_k(
            [idx.corpus.hit_id(int(i)) for i in i1[row] if i >= 0], gold, 10))
        rec2.append(recall_at_k(
            [idx.corpus.hit_id(int(i)) for i in i2[row] if i >= 0], gold, 10))
    assert np.mean(rec1) > 0
    # ties make boundary membership ambiguous (a gold "born in" sentence can
    # tie exactly with distractor "born in" sentences); allow tie-level
    # variation but no systematic gap
    assert np.mean(rec2) == pytest.approx(np.mean(rec1), abs=0.05)


def test_mesh_settings_activate_sharded_engine(tmp_path):
    """settings.json `mesh:` + `index.shard_axis` wiring: the retrieval flow
    constructs the sharded hybrid engine when the mesh has >1 device."""
    from a_modular_rag_framework_tpu.cli.ingest_hotpotqa import ingest
    from a_modular_rag_framework_tpu.core.dto import RetrievalIn
    from a_modular_rag_framework_tpu.modules.retrieval.flow import RetrievalAgentFlow

    samples = SyntheticHotpotQALoader({"count": 12, "seed": 3,
                                       "unique_entities": True}).load()
    docs_out = tmp_path / "docs.jsonl"
    ingest(samples, graph_root=tmp_path / "graph", docs_out=docs_out,
           embed_dim=32, embed_dtype="float32")

    settings = {
        "mesh": {"axes": {"data": -1}},
        "index": {"embed_dim": 32, "dtype": "float32", "shard_axis": "data"},
        "modules": {"retrieval": {
            "type": ("a_modular_rag_framework_tpu.modules.retrieval."
                     "flow:RetrievalAgentFlow"),
            "impl": ("a_modular_rag_framework_tpu.modules.retrieval."
                     "engine_backend:EngineRetrievalBackend"),
            "impl_kwargs": {
                "index_path": str(docs_out),
                "graph_root": str(tmp_path / "graph"),
                "iterative_hops": 1,
            },
        }},
    }
    flow = RetrievalAgentFlow.from_settings(settings)
    engine = flow.backend.engine
    assert isinstance(engine, ShardedHybridEngine), type(engine)
    assert engine.n_shards == 8

    out = flow.retrieve(RetrievalIn(query=samples[0]["question"],
                                    graph_id="", top_k=5, trace_id="t"))
    assert len(out.hits) > 0
    assert out.hits[0].id.startswith("sent::")


def test_graph_impl_settings_reach_engine_config(tmp_path):
    """index.graph_impl / graph_compact_cap flow settings -> backend ->
    EngineConfig (the scale knobs are config-drivable, not code-only)."""
    from a_modular_rag_framework_tpu.cli.ingest_hotpotqa import ingest
    from a_modular_rag_framework_tpu.modules.retrieval.flow import RetrievalAgentFlow

    samples = SyntheticHotpotQALoader({"count": 6, "seed": 3,
                                       "unique_entities": True}).load()
    docs_out = tmp_path / "docs.jsonl"
    ingest(samples, graph_root=tmp_path / "graph", docs_out=docs_out,
           embed_dim=32, embed_dtype="float32")
    settings = {
        "index": {"embed_dim": 32, "dtype": "float32",
                  "graph_impl": "compact", "graph_compact_cap": 128},
        "modules": {"retrieval": {
            "type": ("a_modular_rag_framework_tpu.modules.retrieval."
                     "flow:RetrievalAgentFlow"),
            "impl": ("a_modular_rag_framework_tpu.modules.retrieval."
                     "engine_backend:EngineRetrievalBackend"),
            "impl_kwargs": {"index_path": str(docs_out),
                            "graph_root": str(tmp_path / "graph")},
        }},
    }
    flow = RetrievalAgentFlow.from_settings(settings)
    cfg = flow.backend.engine.config
    assert cfg.graph_impl == "compact"
    assert cfg.graph_compact_cap == 128


def test_dcn_axes_compose_outermost():
    """settings mesh.dcn_axes composes with mesh.axes (DCN outermost): the
    sharded engine shards over the inner data axis while the DCN axis
    replicates — the multi-slice layout, validated on the virtual mesh."""
    from a_modular_rag_framework_tpu.parallel.mesh import mesh_from_settings
    from a_modular_rag_framework_tpu.parallel.sharded_hybrid import (
        _tie_free_corpus,
    )
    from a_modular_rag_framework_tpu.index.builder import build_packed_index

    mesh = mesh_from_settings(
        {"mesh": {"axes": {"data": -1}, "dcn_axes": {"dcn": 2}}})
    assert mesh.axis_names == ("dcn", "data")
    assert dict(mesh.shape) == {"dcn": 2, "data": 4}

    corpus, queries = _tie_free_corpus()
    idx = build_packed_index(corpus, embed_dim=32, embed_dtype="float32")
    cfg = EngineConfig(top_k=10, pool_k=64, graph_window=2,
                       bm25_term_topm=4096, batch_buckets=(8,),
                       graph_pool_exact=True)
    single = QueryEngine(idx, config=cfg)
    sharded = ShardedHybridEngine(idx, mesh=mesh, axis="data", config=cfg)
    assert sharded.n_shards == 4
    # the extra (dcn) axis is data-parallel over the query batch — not
    # mere replication: the batch splits across dcn groups
    assert sharded.dp_axes == ("dcn",)
    assert sharded._dp_size == 2
    r1 = single.query_batch(queries, top_k=10)
    r2 = sharded.query_batch(queries, top_k=10)
    np.testing.assert_array_equal(np.asarray(r1.hits.ids),
                                  np.asarray(r2.hits.ids))
    np.testing.assert_allclose(np.asarray(r1.hits.scores),
                               np.asarray(r2.hits.scores), atol=1e-5)


def test_order_alphas_settings_reach_engine_config(tmp_path):
    """The two-stage fusion knobs flow impl_kwargs -> backend ->
    EngineConfig (config-drivable, as documented in settings.json)."""
    from a_modular_rag_framework_tpu.cli.ingest_hotpotqa import ingest
    from a_modular_rag_framework_tpu.modules.retrieval.flow import RetrievalAgentFlow

    samples = SyntheticHotpotQALoader({"count": 6, "seed": 3,
                                       "unique_entities": True}).load()
    docs_out = tmp_path / "docs.jsonl"
    ingest(samples, graph_root=tmp_path / "graph", docs_out=docs_out,
           embed_dim=32, embed_dtype="float32")
    settings = {
        "index": {"embed_dim": 32, "dtype": "float32"},
        "modules": {"retrieval": {
            "type": ("a_modular_rag_framework_tpu.modules.retrieval."
                     "flow:RetrievalAgentFlow"),
            "impl": ("a_modular_rag_framework_tpu.modules.retrieval."
                     "engine_backend:EngineRetrievalBackend"),
            "impl_kwargs": {"index_path": str(docs_out),
                            "graph_root": str(tmp_path / "graph"),
                            "alpha_text": 0.15, "alpha_graph": 0.7,
                            "alpha_dense": 0.15,
                            "order_alphas": [0.4, 0.2, 0.4]},
        }},
    }
    flow = RetrievalAgentFlow.from_settings(settings)
    cfg = flow.backend.engine.config
    assert cfg.alpha_graph == 0.7
    assert cfg.order_alphas == (0.4, 0.2, 0.4)


def test_sharded_iterative_with_hop2_pool_k_equals_single_chip():
    """Iterative 2-hop with EngineConfig.hop2_pool_k set: the hop-2
    dispatch passes ``pool_k``, which the sharded engine accepts with the
    single-chip semantics, and both engines return the same hits."""
    from __graft_entry__ import _bridge_corpus
    from a_modular_rag_framework_tpu.modules.retrieval.multihop import (
        iterative_retrieve,
    )

    corpus, queries = _bridge_corpus()
    idx = build_packed_index(corpus, embed_dim=32, embed_dtype="float32")
    cfg = EngineConfig(top_k=5, pool_k=32, graph_window=2,
                       bm25_term_topm=4096, batch_buckets=(8,),
                       graph_pool_exact=True, hop2_pool_k=8)
    single = QueryEngine(idx, config=cfg)
    sharded = ShardedHybridEngine(idx, mesh=build_mesh({"data": 8}),
                                  config=cfg)
    ids_a, sc_a, _, diag_a = iterative_retrieve(single, queries, top_k=5)
    ids_b, sc_b, _, diag_b = iterative_retrieve(sharded, queries, top_k=5)
    assert diag_a["hop2_active"] > 0
    assert diag_a["hop2_active"] == diag_b["hop2_active"]
    np.testing.assert_array_equal(np.asarray(ids_a), np.asarray(ids_b))
    np.testing.assert_allclose(np.asarray(sc_a), np.asarray(sc_b), atol=1e-5)
    # the narrower pool reached the sharded program
    r = sharded.query_batch(queries, top_k=5, pool_k=8)
    assert r.diagnostics["pool"]["bm25_pool_k"] == 8


@pytest.mark.parametrize("term_topm,with_expansions", [
    (2, False), (3, True), (4096, True)])
def test_sharded_equals_single_chip_with_narrow_windows(term_topm,
                                                        with_expansions):
    """Phase-1 windows shorter than the posting lists, and query variants
    max-merged (E > 1): the shards see the single-chip windows and each
    variant's pool merges corpus-wide, so the hits are the single chip's."""
    from a_modular_rag_framework_tpu.parallel.sharded_hybrid import (
        _tie_free_corpus,
    )

    corpus, queries = _tie_free_corpus(n_docs=60)
    idx = build_packed_index(corpus, embed_dim=32, embed_dtype="float32")
    longest = int(np.diff(np.asarray(idx.bm25.row_ptr)).max())
    assert term_topm == 4096 or longest > term_topm  # windows do truncate
    cfg = EngineConfig(top_k=10, pool_k=16, graph_window=2,
                       bm25_term_topm=term_topm, batch_buckets=(8,),
                       graph_pool_exact=True)
    kw = {}
    if with_expansions:
        kw["expansions"] = [[queries[(i + 1) % len(queries)],
                             queries[(i + 3) % len(queries)]]
                            for i in range(len(queries))]
    a = QueryEngine(idx, config=cfg).query_batch(queries, top_k=10, **kw)
    b = ShardedHybridEngine(idx, mesh=build_mesh({"data": 8}),
                            config=cfg).query_batch(queries, top_k=10, **kw)
    np.testing.assert_array_equal(np.asarray(a.hits.ids),
                                  np.asarray(b.hits.ids))
    np.testing.assert_allclose(np.asarray(a.hits.scores),
                               np.asarray(b.hits.scores), atol=1e-6)


def test_shard_hybrid_arrays_keep_the_term_window():
    """term_window keeps each term's first postings over the corpus, split
    over the shards by row range."""
    from a_modular_rag_framework_tpu.parallel.sharded_hybrid import (
        _tie_free_corpus,
        shard_hybrid_arrays,
    )

    corpus, _ = _tie_free_corpus()
    idx = build_packed_index(corpus, embed_dim=32, embed_dtype="float32")
    bm = idx.bm25
    rp, ids = np.asarray(bm.row_ptr), np.asarray(bm.doc_ids)
    host = shard_hybrid_arrays(idx, 4, term_window=3)
    n_local = host["n_local"]
    for t in range(len(rp) - 1):
        want = ids[rp[t]:rp[t + 1]][:3]
        got = []
        for sh in range(4):
            lrp = host["csr_row_ptr"][sh]
            got += list(host["csr_doc_ids"][sh][lrp[t]:lrp[t + 1]]
                        + sh * n_local)
        assert sorted(got) == sorted(want.tolist())


@pytest.mark.parametrize("window,df_ratio", [(1024, None), (16, 0.05)])
def test_sharded_equals_single_chip_on_colliding_corpus_at_scale(window,
                                                                 df_ratio):
    """101k colliding-entity rows, compact graph, phase-1 windows holding
    every posting or the bench's scale windows (16 postings per term, df
    above 5% pruned): the sharded engine's hits equal the single-chip
    engine's up to ties. The canonical pool order keeps graph seeding
    independent of where phase-1 left each candidate."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from chip_smoke import _compare, _max_diff

    samples = SyntheticHotpotQALoader({"count": 4600, "seed": 0,
                                       "n_distractors": 8,
                                       "collide_entities": True}).load()
    idx = build_packed_index(SentenceCorpus.from_hotpotqa(samples),
                             embed_dim=32, embed_dtype="float32")
    n = idx.n_docs
    cfg = EngineConfig(top_k=10, pool_k=200, graph_window=2,
                       bm25_term_topm=window, bm25_posting_cap=1024,
                       query_df_ratio_max=df_ratio or 1024.0 / n,
                       batch_buckets=(64,),
                       graph_impl="compact", graph_compact_cap=128,
                       graph_wave_dtype="float32")
    qs = [s["question"] for s in samples[:64]]
    a = QueryEngine(idx, config=cfg).query_batch(qs, top_k=10)
    import jax

    mesh = build_mesh({"data": 4}, devices=jax.devices()[:4])
    b = ShardedHybridEngine(idx, mesh=mesh, config=cfg).query_batch(
        qs, top_k=10)
    assert a.diagnostics["graph_candidates"] == b.diagnostics["graph_candidates"]
    assert _max_diff(a.hits.scores, b.hits.scores) < 1e-5
    assert _compare((a.hits.ids, a.hits.scores),
                    (b.hits.ids, b.hits.scores), 1e-5) == 0
