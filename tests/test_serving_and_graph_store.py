"""Concurrent serving batcher + per-question graph store interop."""
import concurrent.futures
import json

import numpy as np
import pytest

from a_modular_rag_framework_tpu.core.dataset_loader import SyntheticHotpotQALoader
from a_modular_rag_framework_tpu.core.dto import Hit
from a_modular_rag_framework_tpu.engine.query_engine import EngineConfig, QueryEngine
from a_modular_rag_framework_tpu.engine.server import QueryServer
from a_modular_rag_framework_tpu.index.builder import build_packed_index
from a_modular_rag_framework_tpu.index.corpus import SentenceCorpus
from a_modular_rag_framework_tpu.modules.retrieval.graph_store import (
    build_index,
    expand_qmatch_neighbors,
    load_graph_json,
)


@pytest.fixture(scope="module")
def engine():
    samples = SyntheticHotpotQALoader({"count": 12, "seed": 9}).load()
    corpus = SentenceCorpus.from_hotpotqa(samples)
    idx = build_packed_index(corpus, embed_dim=32, embed_dtype="float32")
    return QueryEngine(idx, config=EngineConfig(top_k=5, pool_k=50,
                                                   batch_buckets=(8, 32))), samples


def test_server_batches_concurrent_queries(engine):
    eng, samples = engine
    server = QueryServer(eng, max_batch=16, max_wait_ms=20)
    with server:
        futures = [server.submit(s["question"]) for s in samples]
        results = [f.result(timeout=60) for f in futures]
    # resolution is a lazy Sequence[Hit] view (Hit construction deferred
    # to first access — the serving hot path never builds unread Hits)
    from collections.abc import Sequence

    assert all(isinstance(r, Sequence) and len(r) for r in results)
    assert all(h.id.startswith("sent::") for h in results[0])
    assert isinstance(results[0][0], Hit) and list(results[0])
    assert server.stats["queries"] == len(samples)
    # micro-batching actually batched something
    assert max(server.stats["batch_sizes"]) > 1


def test_server_iterative_mode_matches_direct(engine):
    """mode="iterative" through the server == direct iterative_retrieve
    on the same queries (same ids, same order)."""
    import numpy as np

    from a_modular_rag_framework_tpu.modules.retrieval.multihop import (
        iterative_retrieve,
    )

    eng, samples = engine
    qs = [s["question"] for s in samples[:6]]
    direct_ids, _, _, _ = iterative_retrieve(eng, qs, top_k=5)
    with QueryServer(eng, max_batch=8, max_wait_ms=30) as server:
        futures = [server.submit(q, mode="iterative", top_k=5) for q in qs]
        results = [f.result(timeout=60) for f in futures]
    for row, hits in enumerate(results):
        got = [h.id for h in hits]
        want = [eng.index.corpus.hit_id(int(i))
                for i in direct_ids[row] if i >= 0]
        assert got == want, (row, got, want)


def test_server_mixed_params_grouped(engine):
    eng, samples = engine
    with QueryServer(eng, max_batch=8, max_wait_ms=20) as server:
        f1 = server.submit(samples[0]["question"], top_k=3)
        f2 = server.submit(samples[1]["question"], top_k=5)
        r1, r2 = f1.result(60), f2.result(60)
    assert len(r1) <= 3 and len(r2) <= 5


def test_server_submit_many_matches_singular(engine):
    """A submit_many unit resolves to the same hits, in order, as the
    same queries submitted singly (both ride the same engine batch)."""
    eng, samples = engine
    qs = [s["question"] for s in samples[:6]]
    with QueryServer(eng, max_batch=16, max_wait_ms=20) as server:
        singles = [server.submit(q) for q in qs]
        single_hits = [f.result(timeout=60) for f in singles]
        many = server.submit_many(qs).result(timeout=60)
    assert len(many) == len(qs)
    for got, want in zip(many, single_hits):
        assert [h.id for h in got] == [h.id for h in want]


def test_server_submit_many_mixed_with_singles(engine):
    """Batched units and singular submits share one micro-batch."""
    eng, samples = engine
    qs = [s["question"] for s in samples[:4]]
    with QueryServer(eng, max_batch=32, max_wait_ms=30) as server:
        fm = server.submit_many(qs[:3])
        fs = server.submit(qs[3])
        many, single = fm.result(60), fs.result(60)
    assert len(many) == 3 and all(m for m in many)
    assert single and single[0].id.startswith("sent::")
    # the unit + the single landed in one engine dispatch
    assert max(server.stats["batch_sizes"]) >= 4


def test_server_submit_many_oversized_unit(engine):
    """A unit larger than max_batch still dispatches (never split)."""
    eng, samples = engine
    qs = [s["question"] for s in samples] * 2  # 24 > max_batch=8
    with QueryServer(eng, max_batch=8, max_wait_ms=10) as server:
        out = server.submit_many(qs).result(timeout=60)
    assert len(out) == len(qs) and all(out)


def test_server_submit_many_iterative_and_empty(engine):
    eng, samples = engine
    qs = [s["question"] for s in samples[:3]]
    from a_modular_rag_framework_tpu.modules.retrieval.multihop import (
        iterative_retrieve,
    )

    direct_ids, _, _, _ = iterative_retrieve(eng, qs, top_k=5)
    with QueryServer(eng, max_batch=8, max_wait_ms=10) as server:
        out = server.submit_many(qs, mode="iterative", top_k=5).result(60)
        assert server.submit_many([]).result(1) == []
    for row, hits in enumerate(out):
        want = [eng.index.corpus.hit_id(int(i))
                for i in direct_ids[row] if i >= 0]
        assert [h.id for h in hits] == want


def test_server_threaded_clients(engine):
    eng, samples = engine
    with QueryServer(eng, max_batch=8, max_wait_ms=10) as server:
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            outs = list(pool.map(lambda s: server.query(s["question"]),
                                 samples[:8]))
    assert all(outs)


# ---------------- graph store ----------------


def test_graph_store_roundtrip(tmp_path):
    from a_modular_rag_framework_tpu.core.dto import GraphBuildIn
    from a_modular_rag_framework_tpu.modules.graph_construction.flow import (
        GraphConstructionFlow,
    )
    from a_modular_rag_framework_tpu.modules.graph_construction.impl_arrays import (
        GraphConstructionArrays,
    )

    impl = GraphConstructionArrays(root_dir=str(tmp_path), write_analysis=False)
    # production policy (settings.json): vote fusion without min-vote pruning
    flow = GraphConstructionFlow(impl=impl, edge_builder_kwargs={
        "assembly_policy": {"channels": {"q_overlap": 1.0, "embed_sim": 1.0,
                                         "entity_link": 0.6,
                                         "position_prior": 0.2},
                            "edge_min_vote": 0, "max_edges_per_node": 0}})
    context = [("Doc A", ["Alice went home.", "Alice met Bob there.",
                          "The end came later."]),
               ("Doc B", ["Bob lives in Rome."])]
    out = flow.build(GraphBuildIn(trace_id="t", question_text="Where does Bob live?",
                                  context=context, graph_id="g9"))

    g = load_graph_json(str(tmp_path), "g9")
    nodes_by_id, fwd, bwd, texts, qmatch = build_index(g)
    assert qmatch, "q_match seeds missing"
    # node text is recovered (top-level attr)
    assert any("Rome" in t for t in texts.values())
    expanded = expand_qmatch_neighbors(
        "Where does Bob live?", nodes_by_id, fwd, bwd, texts,
        explicit_qmatch=qmatch, window=1,
    )
    assert expanded
    scores = sorted({round(s, 2) for s, _ in expanded.values()}, reverse=True)
    assert scores[0] == 1.0  # seeds
    if len(scores) > 1:
        assert scores[1] == 0.7  # one-hop decay


def test_graph_store_missing_graph():
    g = load_graph_json("/nonexistent", "nope")
    assert g == {"nodes": [], "edges": []}
    nodes_by_id, fwd, bwd, texts, qmatch = build_index(g)
    assert expand_qmatch_neighbors("q", nodes_by_id, fwd, bwd, texts) == {}


def test_graph_store_fallback_token_seeds(tmp_path):
    # graph without q_match edges -> token-overlap seeding
    g = {"nodes": [{"id": "D::sent0", "type": "sentence", "text": "zebra stripes"},
                   {"id": "D::sent1", "type": "sentence", "text": "lion mane"}],
         "edges": [{"source": "D::sent0", "target": "D::sent1",
                    "type": "next_in_doc"}]}
    nodes_by_id, fwd, bwd, texts, qmatch = build_index(g)
    assert not qmatch
    out = expand_qmatch_neighbors("tell me about zebra", nodes_by_id, fwd, bwd,
                                  texts, window=1)
    assert out["D::sent0"][0] == 1.0
    assert out["D::sent1"][0] == pytest.approx(0.7)


def test_server_stop_rejects_undispatched(engine):
    """Requests still queued at stop() must fail fast, not hang .result()."""
    from concurrent.futures import CancelledError

    from a_modular_rag_framework_tpu.engine.server import QueryServer

    server = QueryServer(engine, max_batch=4)
    # never started: submissions sit in the queue forever unless drained
    fut = server.submit("orphaned question")
    server.stop()
    with pytest.raises(CancelledError):
        fut.result(timeout=1)


def test_adjacency_npz_loads_without_pickle(tmp_path):
    """adjacency.npz must stay allow_pickle=False-loadable (ADVICE r1)."""
    import numpy as np

    from a_modular_rag_framework_tpu.core.dto import GraphBuildIn
    from a_modular_rag_framework_tpu.modules.graph_construction.impl_arrays import (
        GraphConstructionArrays,
    )

    impl = GraphConstructionArrays(root_dir=str(tmp_path), write_analysis=False)
    nodes = [
        {"id": "q1", "type": "question", "text": "who?"},
        {"id": "D::sent0", "type": "sentence", "text": "alpha beta"},
        {"id": "D::sent1", "type": "sentence", "text": "beta gamma"},
    ]
    edges = [
        {"source": "D::sent0", "target": "D::sent1", "type": "next_in_doc"},
        {"source": "q1", "target": "D::sent0", "type": "q_match", "weight": 1.0},
    ]
    impl.build(GraphBuildIn(trace_id="t-pickle", graph_id="g-pickle-test",
                            question_text="who?", nodes=nodes, edges=edges))
    adj = tmp_path / "g-pickle-test" / "adjacency.npz"
    assert adj.exists()
    data = np.load(adj, allow_pickle=False)
    assert data["node_ids"].dtype.kind == "U"
    assert list(data["node_ids"]) == ["q1", "D::sent0", "D::sent1"]


def test_server_concurrent_mixed_modes_with_batch_loop(engine):
    """Stress the cross-thread seams the iterative host-prep pass added:
    server threads answering single AND iterative submits while a
    pipelined iterative batch loop runs on the same engine (shared
    NativeBridge + doc-run cache + prep pools). Every result must equal
    its direct-call oracle."""
    import concurrent.futures

    from a_modular_rag_framework_tpu.modules.retrieval.multihop import (
        iterative_retrieve,
        iterative_retrieve_pipelined,
    )

    eng, samples = engine
    qs = [s["question"] for s in samples[:8]]
    want_iter, _, _, _ = iterative_retrieve(eng, qs, top_k=5)
    want_single = eng.query_batch(qs, top_k=5)
    want_batches = [
        np.asarray(r[0]) for r in iterative_retrieve_pipelined(
            eng, [qs, list(reversed(qs))] * 2, top_k=5)
    ]

    def batch_loop():
        return [np.asarray(r[0]) for r in iterative_retrieve_pipelined(
            eng, [qs, list(reversed(qs))] * 2, top_k=5)]

    with QueryServer(eng, max_batch=8, max_wait_ms=10) as server:
        with concurrent.futures.ThreadPoolExecutor(3) as pool:
            fut_loop = pool.submit(batch_loop)
            fut_it = [server.submit(q, mode="iterative", top_k=5)
                      for q in qs]
            fut_sg = [server.submit(q, top_k=5) for q in qs]
            got_loop = fut_loop.result(timeout=120)
            got_it = [f.result(timeout=120) for f in fut_it]
            got_sg = [f.result(timeout=120) for f in fut_sg]

    for got, want in zip(got_loop, want_batches):
        np.testing.assert_array_equal(got, want)
    for row, hits in enumerate(got_it):
        want = [eng.index.corpus.hit_id(int(i))
                for i in np.asarray(want_iter)[row] if i >= 0]
        assert [h.id for h in hits] == want, row
    w_ids = np.asarray(want_single.hits.ids)
    for row, hits in enumerate(got_sg):
        want = [eng.index.corpus.hit_id(int(i))
                for i in w_ids[row] if i >= 0]
        assert [h.id for h in hits] == want, row
