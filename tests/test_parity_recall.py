"""Recall parity: the device engine vs a host pipeline with the reference's
semantics (BASELINE.md: >= 0.95x reference Recall@10).

The host pipeline reimplements the reference hybrid flow faithfully on the
same corpus: exact dict BM25 (top-200 positive pool), dense cosine over the
BM25 pool, per-channel min-max over each pool, 0.4/0.2/0.4 fusion, top-10.
No graph channel on either side (no per-question graphs in this corpus-mode
comparison; the graph channel has its own oracle in test_engine)."""
import numpy as np
import pytest

from a_modular_rag_framework_tpu.core.dataset_loader import SyntheticHotpotQALoader
from a_modular_rag_framework_tpu.engine.query_engine import EngineConfig, QueryEngine
from a_modular_rag_framework_tpu.eval.harness import gold_hit_ids
from a_modular_rag_framework_tpu.eval.host_reference import (
    HostReference,
    host_reference_pipeline,
    host_reference_pipeline_3ch,
    qmatch_seed_rows_for_sample,
)
from a_modular_rag_framework_tpu.eval.metrics import recall_at_k
from a_modular_rag_framework_tpu.index.builder import build_packed_index
from a_modular_rag_framework_tpu.index.corpus import SentenceCorpus

K = 10
POOL = 200


@pytest.fixture(scope="module")
def setup():
    samples = SyntheticHotpotQALoader({"count": 60, "seed": 21,
                                       "unique_entities": True}).load()
    corpus = SentenceCorpus.from_hotpotqa(samples)
    idx = build_packed_index(corpus, embed_dim=64, embed_dtype="float32")
    return idx, samples, HostReference(idx.corpus.texts(), embed_dim=64)


def test_engine_recall_matches_reference_semantics_3_channels(setup):
    """The FULL 3-channel fusion (text + graph + dense) against the host
    reference-semantics oracle, with per-question q_match seeds — the
    graph-channel-inclusive parity bar (VERDICT r1 item 6)."""
    idx, samples, ref = setup
    engine = QueryEngine(
        idx,
        config=EngineConfig(top_k=K, pool_k=POOL, graph_window=2,
                            include_entity_graph=False,
                            bm25_term_topm=4096, batch_buckets=(64,)),
    )
    qs = [s["question"] for s in samples]
    seeds = [qmatch_seed_rows_for_sample(idx, s) for s in samples]
    result = engine.query_batch(qs, seed_rows=seeds, top_k=K, graph_window=2)
    ids = np.asarray(result.hits.ids)

    engine_recalls, host_recalls = [], []
    for row, s in enumerate(samples):
        gold = gold_hit_ids(s)
        got = [idx.corpus.hit_id(int(i)) for i in ids[row] if i >= 0]
        engine_recalls.append(recall_at_k(got, gold, K))
        host = host_reference_pipeline_3ch(idx, s, seeds[row], ref=ref)
        host_recalls.append(recall_at_k(host, gold, K))

    eng, ref = float(np.mean(engine_recalls)), float(np.mean(host_recalls))
    assert ref > 0, "host 3-channel reference retrieved nothing"
    assert eng >= 0.95 * ref, (
        f"3-channel engine recall {eng:.4f} < 0.95 * reference {ref:.4f}")


def test_engine_recall_at_10_matches_reference_semantics(setup):
    idx, samples, ref = setup
    engine = QueryEngine(
        idx,
        config=EngineConfig(top_k=K, pool_k=POOL, graph_window=0,
                            alpha_graph=0.0, batch_buckets=(64,)),
    )
    qs = [s["question"] for s in samples]
    result = engine.query_batch(qs, top_k=K)
    ids = np.asarray(result.hits.ids)

    engine_recalls, host_recalls = [], []
    for row, s in enumerate(samples):
        gold = gold_hit_ids(s)
        got = [idx.corpus.hit_id(int(i)) for i in ids[row] if i >= 0]
        engine_recalls.append(recall_at_k(got, gold, K))
        host = host_reference_pipeline(idx, s["question"], ref=ref)
        host_recalls.append(recall_at_k(host, gold, K))

    eng, ref = float(np.mean(engine_recalls)), float(np.mean(host_recalls))
    assert ref > 0, "host reference retrieved nothing — fixture broken"
    assert eng >= 0.95 * ref, f"engine recall {eng:.4f} < 0.95 * reference {ref:.4f}"


def test_engine_top10_matches_reference_scores(setup):
    """Exact settings: no phrase tokens, a phase-1 window covering every
    posting list, and a pool as wide as the corpus, so that pool membership
    has no boundary at which BM25 ties could be cut differently. The
    engine's top-10 ids and fused scores then equal the host reference's,
    except where the reference's own scores differ by less than the
    float32 tolerance (`compare_topk`)."""
    from a_modular_rag_framework_tpu.eval.host_reference import compare_topk

    _, samples, _ = setup
    # the reference's BM25 has no phrase pseudo-tokens
    idx = build_packed_index(SentenceCorpus.from_hotpotqa(samples),
                             embed_dim=64, embed_dtype="float32",
                             bm25_phrase_tokens=False)
    ref = HostReference(idx.corpus.texts(), embed_dim=64)
    longest = int(np.diff(np.asarray(idx.bm25.row_ptr)).max())
    engine = QueryEngine(
        idx,
        config=EngineConfig(top_k=K, pool_k=idx.n_docs, graph_window=0,
                            alpha_graph=0.0, batch_buckets=(64,),
                            bm25_term_topm=longest, bm25_posting_cap=longest,
                            graph_pool_exact=True),
    )
    qs = [s["question"] for s in samples]
    result = engine.query_batch(qs, top_k=K)
    ids, scores = np.asarray(result.hits.ids), np.asarray(result.hits.scores)
    for row, q in enumerate(qs):
        fused = ref.fused(q, alphas=(0.4, 0.0, 0.4), pool_k=idx.n_docs)
        ok, why = compare_topk(ids[row], scores[row], fused, K, tol=1e-5)
        assert ok, f"query {row}: {why}"
