"""Iterative bridge-entity retrieval: hop-2 recall must improve markedly."""
import numpy as np
import pytest

from a_modular_rag_framework_tpu.core.dataset_loader import SyntheticHotpotQALoader
from a_modular_rag_framework_tpu.engine.query_engine import EngineConfig, QueryEngine
from a_modular_rag_framework_tpu.index.builder import build_packed_index
from a_modular_rag_framework_tpu.index.corpus import SentenceCorpus
from a_modular_rag_framework_tpu.modules.retrieval.multihop import (
    bridge_entities,
    hop2_queries_for,
    iterative_retrieve,
)


@pytest.fixture(scope="module")
def setup():
    samples = SyntheticHotpotQALoader({"count": 20, "seed": 5}).load()
    corpus = SentenceCorpus.from_hotpotqa(samples)
    idx = build_packed_index(corpus, embed_dim=64, embed_dtype="float32")
    engine = QueryEngine(idx, config=EngineConfig(top_k=20, pool_k=100,
                                                     graph_window=2,
                                                     batch_buckets=(16,)))
    return engine, samples


def _recall(ids, samples, by):
    hit = total = hop2 = 0
    for b, s in enumerate(samples):
        got = set(int(i) for i in ids[b] if i >= 0)
        for hop, (t, sid) in enumerate(s["supporting_facts"]):
            row = by.get((t, sid))
            if row is None:
                continue
            total += 1
            hit += int(row in got)
            hop2 += int(hop == 1 and row in got)
    return hit, total, hop2


def test_bridge_entity_extraction():
    q = "In which city was the collaborator of Alice Smith born?"
    texts = [
        "Bob Jones was born in Rome.",  # no question entity -> ignored
        "Alice Smith collaborated closely with Bob Jones.",
        "Later in life Alice Smith retired.",  # 'Later' must not be a bridge
    ]
    titles = {"Alice Smith", "Bob Jones"}
    bridges = bridge_entities(q, texts, known_titles=titles)
    assert bridges == ["Bob Jones"]
    variants = hop2_queries_for(q, bridges)
    assert variants and "Bob Jones" in variants[0] and "born" in variants[0]


def test_iterative_beats_single_pass(setup):
    engine, samples = setup
    by = engine.index.corpus.row_by_title_sid()
    qs = [s["question"] for s in samples[:16]]

    r1 = engine.query_batch(qs, top_k=20)
    h1, total, h2_single = _recall(np.asarray(r1.hits.ids), samples[:16], by)

    ids, scores, norms, diag = iterative_retrieve(engine, qs, top_k=20)
    h, _, h2_iter = _recall(ids, samples[:16], by)

    assert diag["hop2_active"] > 8
    assert h > h1, f"iterative {h} <= single {h1} (of {total})"
    assert h2_iter > h2_single
    # scores sorted descending, norms aligned
    assert ids.shape == (16, 20) and norms.shape == (16, 3, 20)
    assert (np.diff(scores, axis=1) <= 1e-6).all()


def test_iterative_pipelined_matches_sequential(setup):
    """The 3-stage pipelined iterative retriever yields, per batch and in
    order, exactly what iterative_retrieve returns for that batch."""
    from a_modular_rag_framework_tpu.modules.retrieval.multihop import (
        iterative_retrieve_pipelined,
    )

    engine, samples = setup
    qs = [s["question"] for s in samples[:16]]
    batches = [qs, list(reversed(qs)), qs[:8] + qs[:8]]
    seq = [iterative_retrieve(engine, b, top_k=20) for b in batches]
    pipe = list(iterative_retrieve_pipelined(engine, batches, top_k=20))
    assert len(pipe) == len(seq)
    for (i1, s1, n1, d1), (i2, s2, n2, d2) in zip(seq, pipe):
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_allclose(s1, s2, atol=1e-6)
        np.testing.assert_allclose(n1, n2, atol=1e-6)
        assert d1["hop2_active"] == d2["hop2_active"]


def test_hop2_graph_window_reaches_hop2_dispatch(setup):
    """EngineConfig.hop2_graph_window narrows the HOP-2 program's graph
    wave only: hop-1 keeps the caller's window, hop-2 dispatches with the
    configured one (None = parity with hop-1)."""
    from dataclasses import replace

    engine, samples = setup
    qs = [s["question"] for s in samples[:16]]

    seen: list = []
    orig = engine.query_batch_async

    def spy(queries, **kw):
        seen.append(kw.get("graph_window"))
        return orig(queries, **kw)

    engine.query_batch_async = spy  # both hops route through the async seam
    try:
        iterative_retrieve(engine, qs, top_k=20, graph_window=2)
        assert seen == [2, 2], f"parity default broke: {seen}"
        seen.clear()
        engine.config = replace(engine.config, hop2_graph_window=1)
        ids_narrow, *_ = iterative_retrieve(engine, qs, top_k=20,
                                            graph_window=2)
        assert seen == [2, 1], f"hop-2 window not applied: {seen}"
        assert ids_narrow.shape == (16, 20)
    finally:
        del engine.query_batch_async
        engine.config = replace(engine.config, hop2_graph_window=None)


def test_vectorized_merge_matches_python_oracle():
    """_merge_hop2 (vectorized) == _merge_hop2_py (loop oracle) on random
    tie-free inputs across reserve settings, inactive rows, -1 padding,
    and hop-1/hop-2 id overlap."""
    from a_modular_rag_framework_tpu.modules.retrieval.multihop import (
        _merge_hop2, _merge_hop2_py,
    )

    rng = np.random.default_rng(7)
    B, K1, K2 = 32, 20, 10
    for trial in range(7):
        # trials 5-6 quantize scores to force EXACT ties across different
        # ids (graph-only hits collide constantly at alpha*decay values) —
        # both implementations break ties by ascending id
        quantize = trial >= 5
        for reserve in (None, 0, 3, 8):
            ids1 = np.stack([rng.choice(500, K1, replace=False)
                             for _ in range(B)]).astype(np.int32)
            # make some hop-2 ids overlap hop-1, some new
            ids2 = np.stack([
                np.concatenate([rng.choice(ids1[b], K2 // 2, replace=False),
                                rng.choice(np.arange(500, 600), K2 - K2 // 2,
                                           replace=False)])
                for b in range(B)]).astype(np.int32)
            ids1[0, :5] = -1
            ids2[1, :4] = -1
            scores1 = np.sort(rng.random((B, K1)).astype(np.float32) + 0.5,
                              axis=1)[:, ::-1]
            scores2 = np.sort(rng.random((B, K2)).astype(np.float32) + 0.8,
                              axis=1)[:, ::-1]
            if quantize:
                scores1 = np.round(scores1 * 4) / 4
                scores2 = np.round(scores2 * 4) / 4
            norms1 = rng.random((3, B, K1)).astype(np.float32)
            norms2 = rng.random((3, B, K2)).astype(np.float32)
            active = [bool(rng.random() > 0.2) for _ in range(B)]

            r2 = type("R", (), {})()
            r2.hits = type("H", (), {})()
            r2.hits.ids = ids2
            r2.hits.scores = scores2
            r2.channel_norms = norms2
            ctx = {"ids1": ids1, "scores1": scores1, "norms1": norms1,
                   "active": active, "diagnostics": {"d": 1}}
            kw = dict(top_k=10, hop_decay=0.5, hop2_reserve=reserve)
            iv, sv, nv, dv = _merge_hop2(["q"] * B, dict(ctx), r2, **kw)
            ip, sp, np_, dp = _merge_hop2_py(["q"] * B, dict(ctx), r2, **kw)
            np.testing.assert_array_equal(iv, ip,
                                          err_msg=f"reserve={reserve}")
            np.testing.assert_allclose(sv, sp, atol=1e-6)
            np.testing.assert_allclose(nv, np_, atol=1e-6)
            assert dv == dp


def test_vectorized_merge_pads_when_hits_narrower_than_top_k():
    """Tiny corpora: engine hit widths clamp below top_k; the vectorized
    merge must pad to top_k like the loop oracle, not crash."""
    from a_modular_rag_framework_tpu.modules.retrieval.multihop import (
        _merge_hop2, _merge_hop2_py,
    )

    B, K1, K2, top_k = 2, 4, 4, 10
    rng = np.random.default_rng(3)
    ids1 = np.array([[0, 1, 2, 3], [3, 2, -1, -1]], np.int32)
    scores1 = np.sort(rng.random((B, K1)).astype(np.float32))[:, ::-1]
    ids2 = np.array([[2, 5, -1, -1], [0, 1, 5, -1]], np.int32)
    scores2 = np.sort(rng.random((B, K2)).astype(np.float32))[:, ::-1]
    r2 = type("R", (), {})()
    r2.hits = type("H", (), {})()
    r2.hits.ids = ids2
    r2.hits.scores = scores2
    r2.channel_norms = rng.random((3, B, K2)).astype(np.float32)
    ctx = {"ids1": ids1, "scores1": scores1,
           "norms1": rng.random((3, B, K1)).astype(np.float32),
           "active": [True, True], "diagnostics": {}}
    kw = dict(top_k=top_k, hop_decay=0.5, hop2_reserve=None)
    iv, sv, nv, _ = _merge_hop2(["a", "b"], dict(ctx), r2, **kw)
    ip, sp, np_, _ = _merge_hop2_py(["a", "b"], dict(ctx), r2, **kw)
    assert iv.shape == (B, top_k)
    np.testing.assert_array_equal(iv, ip)
    np.testing.assert_allclose(sv, sp, atol=1e-6)
    np.testing.assert_allclose(nv, np_, atol=1e-6)


def test_iterative_backend_hits_tagged(setup):
    """The hybrid backend with iterative_hops=2 returns hydrated hits."""
    from a_modular_rag_framework_tpu.core.dto import RetrievalIn
    from a_modular_rag_framework_tpu.modules.retrieval.engine_backend import (
        EngineRetrievalBackend,
    )

    engine, samples = setup
    backend = EngineRetrievalBackend(engine=engine, iterative_hops=2)
    out = backend.retrieve(RetrievalIn(query=samples[0]["question"],
                                       graph_id="", top_k=10, trace_id="t"))
    assert out.hits and out.hits[0].id.startswith("sent::")
    assert "hop2_active" in out.diagnostics


def test_hop2_reserve_protects_bridge_evidence():
    """Decayed hop-2 hits must not be squeezed out of the merged top-k by
    hop-1's distractor tail: the merge reserves slots for hop-2-only ids."""
    import numpy as np

    from a_modular_rag_framework_tpu.core.dto import HitBatch
    from a_modular_rag_framework_tpu.engine.query_engine import QueryResult
    from a_modular_rag_framework_tpu.modules.retrieval.multihop import (
        iterative_retrieve,
    )

    class FakeCorpus:
        # hop-1 texts name the question entity + bridge; titles exist
        docs = ([{"title": "Alice Prior", "sent_id": 0,
                  "text": "Alice Prior collaborated with Bob Quine."}]
                + [{"title": f"D{i}", "sent_id": 0,
                    "text": f"Someone was born in City{i}."}
                   for i in range(1, 30)]
                + [{"title": "Bob Quine", "sent_id": 0,
                    "text": "Bob Quine was born in Target City."}])

    class FakeIndex:
        corpus = FakeCorpus()

    class FakeEngine:
        index = FakeIndex()
        calls = 0

        def query_batch(self, queries, **kw):
            k = kw.get("top_k", 10)
            self.calls += 1
            if self.calls == 1:  # hop 1: ids 0..19, tail scores ~0.5
                ids = np.arange(20, dtype=np.int32)[None, :k]
                scores = np.linspace(1.0, 0.5, 20, dtype=np.float32)[None, :k]
            else:  # hop 2: the bridge doc (id 30) leads
                ids = np.asarray([[30] + list(range(1, k))], dtype=np.int32)
                scores = np.linspace(0.9, 0.2, k, dtype=np.float32)[None]
            return QueryResult(
                hits=HitBatch(ids=ids, scores=scores),
                channel_norms=np.zeros((3, 1, ids.shape[1]), np.float32),
            )

    ids, scores, norms, diag = iterative_retrieve(
        FakeEngine(), ["Where was the collaborator of Alice Prior born?"],
        top_k=10)
    assert diag["hop2_active"] == 1
    # id 30 scores 0.9 * 0.5 = 0.45 < every hop-1 tail score, but the
    # reserve must still place it in the top-10
    assert 30 in ids[0].tolist()


def test_doc_bridge_runs_cache_and_invalidation(setup):
    """The per-doc bridge-run cache must (a) produce identical results to
    the uncached path, (b) populate on first use, (c) invalidate when the
    engine's index object is swapped."""
    from a_modular_rag_framework_tpu.modules.retrieval.multihop import (
        doc_bridge_runs, _prep_and_dispatch_hop2)

    engine, samples = setup
    qs = [s["question"] for s in samples[:8]]
    r1 = engine.query_batch(qs, top_k=20)

    # uncached oracle: bridge_entities on raw texts
    titles = {d.get("title") for d in engine.index.corpus.docs} - {None}
    ids1 = np.asarray(r1.hits.ids)
    oracle = []
    for b, q in enumerate(qs):
        texts = [engine.index.corpus.docs[int(i)].get("text", "")
                 for i in ids1[b][:20] if i >= 0]
        oracle.append(bridge_entities(q, texts, known_titles=titles))

    engine._mh_doc_runs = None  # force rebuild
    ctx, _p = _prep_and_dispatch_hop2(
        engine, qs, r1, top_k=10, hop1_inspect=20, max_bridge_entities=4,
        graph_window=None, trace_id="")
    cached_qs = ctx["diagnostics"]["hop2_queries"]
    for b, bridges in enumerate(oracle):
        if bridges:
            assert bridges[0] in cached_qs[b]
        else:
            assert cached_qs[b] == ""

    # a cache is populated and keyed on the index object: the native
    # bridge (module-level weak dict, shared by engines over one index)
    # when available, else the Python per-doc runs cache
    import a_modular_rag_framework_tpu.modules.retrieval.multihop as _mh
    nb_cached = (_mh._NATIVE_BRIDGES or {}).get(engine.index)
    if nb_cached is not None:
        assert nb_cached.available
    else:
        key, runs = engine._mh_doc_runs
        assert key is engine.index and len(runs) > 0
        # every cached entry matches a fresh extraction
        for ii, entry in list(runs.items())[:10]:
            text = engine.index.corpus.docs[ii].get("text", "")
            assert entry == doc_bridge_runs(text, titles)

    # the PYTHON cache path still populates when the native path is
    # unavailable (forced fallback: gate every index off)
    orig_bridges = _mh._NATIVE_BRIDGES
    import weakref
    _mh._NATIVE_BRIDGES = weakref.WeakKeyDictionary()
    _mh._NATIVE_BRIDGES[engine.index] = None  # gated
    engine._mh_doc_runs = None
    try:
        _prep_and_dispatch_hop2(
            engine, qs, r1, top_k=10, hop1_inspect=20,
            max_bridge_entities=4, graph_window=None, trace_id="")
        key, runs = engine._mh_doc_runs
        assert key is engine.index and len(runs) > 0
        for ii, entry in list(runs.items())[:10]:
            text = engine.index.corpus.docs[ii].get("text", "")
            assert entry == doc_bridge_runs(text, titles)
    finally:
        _mh._NATIVE_BRIDGES = orig_bridges

    # swapping the index invalidates: a different index object gets its
    # own bridge entry; the stale Python cache must not survive either
    old_index = engine.index

    class _Swap:  # same attributes, different identity
        def __getattr__(self, name):
            return getattr(old_index, name)
    engine.index = _Swap()
    try:
        _prep_and_dispatch_hop2(
            engine, qs, r1, top_k=10, hop1_inspect=20,
            max_bridge_entities=4, graph_window=None, trace_id="")
        assert engine.index in _mh._NATIVE_BRIDGES
        assert old_index is not engine.index
    finally:
        engine.index = old_index


def test_native_bridge_gating(setup):
    """_native_bridge_for must gate off oversized or mostly-non-simple
    corpora (registration copies text into native memory) and cache one
    bridge per index object across engines."""
    import a_modular_rag_framework_tpu.modules.retrieval.multihop as _mh

    engine, _samples = setup
    docs = engine.index.corpus.docs
    # fresh cache for the assertions below
    import weakref
    orig = _mh._NATIVE_BRIDGES
    _mh._NATIVE_BRIDGES = weakref.WeakKeyDictionary()
    try:
        nb1 = _mh._native_bridge_for(engine.index, docs)
        nb2 = _mh._native_bridge_for(engine.index, docs)
        if nb1 is not None:  # native toolchain present
            assert nb1 is nb2  # one copy per index, shared across engines

        # size gate
        old_cap = _mh._NATIVE_BRIDGE_MAX_BYTES
        _mh._NATIVE_BRIDGE_MAX_BYTES = 10
        _mh._NATIVE_BRIDGES = weakref.WeakKeyDictionary()
        try:
            assert _mh._native_bridge_for(engine.index, docs) is None
        finally:
            _mh._NATIVE_BRIDGE_MAX_BYTES = old_cap

        # usefulness gate: a corpus of non-simple texts stays on Python
        class _FakeIndex:
            pass
        weird = [{"title": "X", "text": "José Čapek's notes — volume %d" % i}
                 for i in range(32)]
        _mh._NATIVE_BRIDGES = weakref.WeakKeyDictionary()
        assert _mh._native_bridge_for(_FakeIndex(), weird) is None
    finally:
        _mh._NATIVE_BRIDGES = orig


def test_hop2_max_bridges_config_caps_variants():
    """EngineConfig.hop2_max_bridges bounds the hop-2 dispatch's variant
    count (1 query + expansions): the bridge budget flows from config when
    the caller doesn't pass max_bridge_entities, and an explicit caller
    value still wins. Fewer variants = smaller variant bucket E = less
    hop-2 BM25 phase-1 sort width (the scale rows' tuning knob)."""
    import numpy as np

    from a_modular_rag_framework_tpu.core.dto import HitBatch
    from a_modular_rag_framework_tpu.engine.query_engine import QueryResult

    class FakeCorpus:
        # hop-1 doc names the question entity + THREE bridge titles
        docs = ([{"title": "Alice Prior", "sent_id": 0,
                  "text": "Alice Prior worked with Bob Quine and "
                          "Carol Reyes and Dave Stone."}]
                + [{"title": t, "sent_id": 0, "text": f"{t} info."}
                   for t in ("Bob Quine", "Carol Reyes", "Dave Stone")])

    class FakeIndex:
        corpus = FakeCorpus()

    class _Cfg:
        hop2_max_bridges = None

    class FakeEngine:
        index = FakeIndex()
        config = _Cfg()

        def __init__(self):
            self.h2_widths = []
            self.calls = 0

        def query_batch(self, queries, **kw):
            self.calls += 1
            if self.calls > 1:  # hop-2 dispatch
                exp = kw.get("expansions") or [[] for _ in queries]
                self.h2_widths.append(max(1 + len(e) for e in exp))
            k = kw.get("top_k", 10)
            ids = np.arange(len(FakeCorpus.docs), dtype=np.int32)[None, :k]
            scores = np.linspace(1.0, 0.5, ids.shape[1],
                                 dtype=np.float32)[None]
            return QueryResult(
                hits=HitBatch(ids=ids, scores=scores),
                channel_norms=np.zeros((3, 1, ids.shape[1]), np.float32),
            )

    q = ["Where was the collaborator of Alice Prior born?"]

    eng = FakeEngine()
    iterative_retrieve(eng, q, top_k=4)
    assert eng.h2_widths == [3], f"default bridge budget: {eng.h2_widths}"

    eng = FakeEngine()
    eng.config.hop2_max_bridges = 2
    iterative_retrieve(eng, q, top_k=4)
    assert eng.h2_widths == [2], f"config bridge cap: {eng.h2_widths}"

    # explicit caller value overrides config
    eng = FakeEngine()
    eng.config.hop2_max_bridges = 2
    iterative_retrieve(eng, q, top_k=4, max_bridge_entities=1)
    assert eng.h2_widths == [1], f"caller override: {eng.h2_widths}"
