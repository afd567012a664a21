"""Native C++ host runtime vs the Python reference paths (bit-exact)."""
import numpy as np
import pytest

from a_modular_rag_framework_tpu.models.hash_embed import HashEmbedEncoder, tokenize
from a_modular_rag_framework_tpu.native import (
    bm25_build_native,
    featurize_batch_native,
    native_available,
    token_counts_native,
)
from a_modular_rag_framework_tpu.ops.bm25 import Bm25DeviceIndex

pytestmark = pytest.mark.skipif(not native_available(),
                                reason="native toolchain unavailable")

TEXTS = [
    "The Quick brown-fox jumps!! over the lazy dog 42 times",
    "",
    "unicode déjà-vu splits on accents",
    "repeated repeated repeated tokens",
    "a",
]


def _py_featurize(texts, dim, max_features):
    enc = HashEmbedEncoder(dim=dim, max_features=max_features)
    # force the pure-python loop
    import a_modular_rag_framework_tpu.models.hash_embed as he

    B, L = len(texts), max_features
    buckets = np.zeros((B, L), dtype=np.int32)
    signs = np.zeros((B, L), dtype=np.float32)
    for i, t in enumerate(texts):
        feats = he._features(t)[:L]
        for j, feat in enumerate(feats):
            bkt, s = he._bucket_sign(feat, dim)
            buckets[i, j] = bkt
            signs[i, j] = s
    return buckets, signs


def test_featurize_bit_exact():
    nb, ns = featurize_batch_native(TEXTS, 64, 32)
    pb, ps = _py_featurize(TEXTS, 64, 32)
    np.testing.assert_array_equal(nb, pb)
    np.testing.assert_array_equal(ns, ps)


def test_token_counts_match_python():
    counts = token_counts_native(TEXTS)
    want = [len(tokenize(t)) for t in TEXTS]
    np.testing.assert_array_equal(counts, want)


def test_bm25_build_bit_exact():
    out = bm25_build_native(TEXTS)
    ref = Bm25DeviceIndex.build_python(TEXTS)
    assert out["vocab"] == ref.vocab
    np.testing.assert_array_equal(out["row_ptr"], ref.row_ptr)
    np.testing.assert_array_equal(out["doc_ids"], ref.doc_ids)
    np.testing.assert_array_equal(out["tfs"], ref.tfs)
    np.testing.assert_array_equal(out["doc_lens"], ref.doc_lens)
    np.testing.assert_allclose(out["scores"], ref.ensure_scores(), rtol=1e-5)


def test_bm25_build_streaming_chunks_equal_single_pass():
    big = TEXTS * 20
    a = bm25_build_native(big, chunk=7)
    b = bm25_build_native(big, chunk=100000)
    assert a["vocab"] == b["vocab"]
    np.testing.assert_array_equal(a["doc_ids"], b["doc_ids"])
    np.testing.assert_allclose(a["scores"], b["scores"])


def test_default_build_uses_native_and_matches_python():
    idx_native = Bm25DeviceIndex.build(TEXTS)
    idx_py = Bm25DeviceIndex.build(TEXTS, use_native=False)
    assert idx_native.vocab == idx_py.vocab
    np.testing.assert_array_equal(idx_native.doc_ids, idx_py.doc_ids)
    np.testing.assert_allclose(idx_native.ensure_scores(), idx_py.ensure_scores(),
                               rtol=1e-5)


def test_native_vocab_lookup_matches_python():
    from a_modular_rag_framework_tpu.native.binding import NativeVocab

    corpus = ["alpha beta gamma", "beta delta", "gamma gamma epsilon"]
    idx = Bm25DeviceIndex.build_python(corpus)
    nv = NativeVocab(idx.vocab)
    assert nv.available
    queries = ["beta gamma unknownword", "", "epsilon alpha alpha"]
    got = nv.lookup_batch(queries, max_terms=6)
    for q, row in zip(queries, got):
        want = [idx.vocab[t] for t in tokenize(q) if t in idx.vocab][:6]
        want = want + [-1] * (6 - len(want))
        assert row.tolist() == want, (q, row.tolist(), want)


def test_native_unicode_lowercase_parity():
    """Non-ASCII chars that lower() into ASCII (Kelvin sign, dotted I) must
    tokenize identically on the native and Python paths (ADVICE r1)."""
    from a_modular_rag_framework_tpu.native.binding import (
        bm25_build_native,
        token_counts_native,
    )

    texts = ["the K elvin sign", "İstanbul style", "plain ascii text"]
    counts = token_counts_native(texts)
    if counts is None:
        import pytest

        pytest.skip("native lib unavailable")
    want = [len(tokenize(t)) for t in texts]
    assert counts.tolist() == want

    got = bm25_build_native(texts)
    ref = Bm25DeviceIndex.build_python(texts)
    assert set(got["vocab"]) == set(ref.vocab)


def test_native_bridge_matches_python_hop2():
    """NativeBridge's hop-2 query construction must be string-identical to
    the Python path (bridge_entities + hop2_queries_for) on simple texts,
    and flag non-simple inputs for fallback instead of approximating."""
    import numpy as np
    import pytest

    from a_modular_rag_framework_tpu.modules.retrieval.multihop import (
        _QUESTION_WORDS,
        bridge_entities,
        doc_bridge_runs,
        hop2_queries_for,
    )
    from a_modular_rag_framework_tpu.native.binding import NativeBridge

    docs = [
        {"title": "Alden Kelholan", "text": "Alden Kelholan was born in Dunmore."},
        {"title": "Sage Silverton", "text": "Sage Silverton worked with Alden Kelholan on the archive."},
        {"title": "Dunmore", "text": "Dunmore is a town. Sage Silverton visited it."},
        {"title": "Ribbon Award", "text": "The Ribbon Award honored Sage Silverton and Mira Tull."},
        {"title": "Mira Tull", "text": "Later in life Mira Tull retired near Sage Silverton."},
        {"title": "José Čapek", "text": "José Čapek met Sage Silverton."},  # non-simple
        {"title": "O'Hara", "text": "O'Hara's journal mentions Sage Silverton."},  # quote
    ]
    nb = NativeBridge(docs, _QUESTION_WORDS)
    if not nb.available:
        pytest.skip("native lib unavailable")

    titles = {d["title"] for d in docs}
    queries = [
        "In which city was the collaborator of Sage Silverton born?",
        "Who worked with Sage Silverton?",
        "What award did Sage Silverton win?",
        "no capitals here at all",
        "Which town did Sage Silverton visit?",
    ]
    # rows 0-4 are simple; query 0 inspects them all
    ids = np.array([[1, 0, 2, 3, 4]] * len(queries), dtype=np.int32)
    got = nb.hop2_batch(queries, ids)
    assert got is not None
    for b, q in enumerate(queries):
        texts = [docs[i]["text"] for i in ids[b] if i >= 0]
        runs = [doc_bridge_runs(t, titles) for t in texts]
        bridges = bridge_entities(q, texts, max_entities=4,
                                  known_titles=titles, text_runs=runs)
        want = hop2_queries_for(q, bridges) if bridges else []
        assert got[b] == want, (q, got[b], want)

    # queries/docs needing Python: non-simple doc inspected -> None flag
    ids2 = np.array([[5, 1, 0, -1, -1]], dtype=np.int32)
    got2 = nb.hop2_batch(["Who met Sage Silverton?"], ids2)
    assert got2[0] is None
    ids3 = np.array([[6, 1, -1, -1, -1]], dtype=np.int32)
    got3 = nb.hop2_batch(["Who mentions Sage Silverton?"], ids3)
    assert got3[0] is None
    # non-simple QUERY -> None flag
    got4 = nb.hop2_batch(["Où was José born?"], np.array([[0, 1, -1, -1, -1]], dtype=np.int32))
    assert got4[0] is None


def _mixed_corpus():
    """Corpus exercising every native-gate branch: ASCII runs, middle
    initials, digits, non-ASCII diacritics, apostrophes, hyphens, empty."""
    from a_modular_rag_framework_tpu.core.dataset_loader import (
        SyntheticHotpotQALoader,
    )
    from a_modular_rag_framework_tpu.index.corpus import SentenceCorpus

    samples = SyntheticHotpotQALoader({"count": 30, "seed": 7,
                                       "collide_entities": True}).load()
    corpus = SentenceCorpus.from_hotpotqa(samples)
    extra = [
        "José Çelik moved to São Paulo with Anna Maria Weiss.",
        "O'Brien met Jean-Luc Picard and John D. Rockefeller in 1941.",
        "Area51 Bob saw W3C specs; ALLCAPS stays out, McDonald rides.",
        "", "   ", "no capitals here at all",
        "Anna Maria Weiss wrote to José Çelik about the Weiss archive.",
    ]
    docs = list(corpus.docs)
    for i, t in enumerate(extra):
        docs.append({"doc_id": f"Extra {i}#0", "title": f"Extra {i}",
                     "sent_id": 0, "text": t})
    return SentenceCorpus(docs=docs)


def test_entity_graph_native_bit_exact():
    """Native entity adjacency == the (deterministic) Python builder on a
    corpus that mixes simple ASCII rows with Unicode/apostrophe/hyphen
    rows (the per-row Python-extraction fallback path)."""
    from a_modular_rag_framework_tpu.index.builder import build_sentence_graph

    corpus = _mixed_corpus()
    nat = build_sentence_graph(corpus, use_native=True)
    py = build_sentence_graph(corpus, use_native=False)
    assert np.array_equal(nat["next_in_doc"], py["next_in_doc"])
    assert np.array_equal(nat["entity"], py["entity"])
    # the adjacency is non-trivial (entities actually link rows)
    assert (nat["entity"] >= 0).sum() > 0


def test_entity_graph_native_degree_saturation_parity():
    """Hub saturation: one entity mentioned by more rows than max_degree
    forces the capped-dedup insertion order to matter; native must pack
    the same neighbors as Python."""
    from a_modular_rag_framework_tpu.index.builder import build_sentence_graph
    from a_modular_rag_framework_tpu.index.corpus import SentenceCorpus

    docs = []
    for i in range(24):
        docs.append({"doc_id": f"D{i}#0", "title": f"D{i}", "sent_id": 0,
                     "text": f"Alpha Omega visited site {i} with Beta Kappa."})
    corpus = SentenceCorpus(docs=docs)
    nat = build_sentence_graph(corpus, max_degree=8, entity_chain_cap=16,
                               use_native=True)
    py = build_sentence_graph(corpus, max_degree=8, entity_chain_cap=16,
                              use_native=False)
    assert np.array_equal(nat["entity"], py["entity"])


def test_bm25_phrase_tokens_native_bit_exact():
    """phrase_tokens=True native build == Python phrase_augment pre-pass +
    Python build, on mixed simple/non-simple texts."""
    from a_modular_rag_framework_tpu.models.hash_embed import phrase_augment

    corpus = _mixed_corpus()
    texts = [d.get("text", "") for d in corpus.docs]
    nat = Bm25DeviceIndex.build(texts, phrase_tokens=True, use_native=True)
    py = Bm25DeviceIndex.build_python([phrase_augment(t) for t in texts])
    assert nat.vocab == py.vocab
    assert np.array_equal(nat.doc_ids, py.doc_ids)
    assert np.array_equal(nat.row_ptr, py.row_ptr)
    assert np.allclose(nat.scores, py.scores, atol=0)
    assert np.array_equal(nat.doc_lens, py.doc_lens)
    # phrase pseudo-tokens actually present
    assert any("00" in t for t in nat.vocab)


def test_hash_embed_batch_native_bit_exact():
    """The fused featurize+accumulate+normalize C path is bit-identical to
    encode_token_batch(featurize(...)) — signs are +-1 so bucket sums are
    exact small integers; the norm rounds identically."""
    from a_modular_rag_framework_tpu.native import hash_embed_batch_native

    enc = HashEmbedEncoder(dim=64)
    texts = TEXTS + ["John D. Rockefeller founded Standard Oil in 1870",
                     "x " * 400]  # > max_features features
    fused = hash_embed_batch_native(texts, enc.dim, enc.max_features)
    bk, sg = enc.featurize(texts)
    ref = enc.encode_token_batch(bk, sg)
    assert np.array_equal(fused, ref)


def test_native_bridge_pruned_emission_matches_prune_query():
    """hop2_batch(high_df_blob=...) must emit exactly
    prune_query(raw_variant, high_df) for every variant, including the
    kept-empty -> raw fallback and the phrase pseudo-token placement."""
    import numpy as np
    import pytest

    from a_modular_rag_framework_tpu.engine.query_engine import prune_query
    from a_modular_rag_framework_tpu.modules.retrieval.multihop import (
        _QUESTION_WORDS,
    )
    from a_modular_rag_framework_tpu.native.binding import NativeBridge

    docs = [
        {"title": "Alden Kelholan", "text": "Alden Kelholan was born in Dunmore."},
        {"title": "Sage Silverton", "text": "Sage Silverton worked with Alden Kelholan on the archive."},
        {"title": "Dunmore", "text": "Dunmore is a town. Sage Silverton visited it."},
        {"title": "Ribbon Award", "text": "The Ribbon Award honored Sage Silverton and Mira Tull."},
        {"title": "Mira Tull", "text": "Later in life Mira Tull retired near Sage Silverton."},
    ]
    nb = NativeBridge(docs, _QUESTION_WORDS)
    if not nb.available:
        pytest.skip("native lib unavailable")

    queries = [
        "In which city was the collaborator of Sage Silverton born?",
        "Who worked with Sage Silverton?",
        "What award did Sage Silverton win?",
        "Which town did Sage Silverton visit?",
    ]
    ids = np.array([[1, 0, 2, 3, 4]] * len(queries), dtype=np.int32)
    raw = nb.hop2_batch(queries, ids)

    # high-df sets exercising each branch: predicate words, a bridge-name
    # token, the phrase pseudo-token itself, and everything-drops
    cases = [
        {"worked", "with", "born", "archive", "visited", "town", "award",
         "honored", "collaborator", "city", "win"},
        {"alden", "mira"},
        {"alden00kelholan", "mira00tull", "ribbon00award"},
        # everything high-df -> kept empty -> raw variant must come back
        {"alden", "kelholan", "mira", "tull", "ribbon", "award", "dunmore",
         "alden00kelholan", "mira00tull", "ribbon00award", "worked", "with",
         "born", "archive", "visited", "town", "honored", "collaborator",
         "city", "win"},
    ]
    for high_df in cases:
        blob = "\n".join(sorted(high_df)).encode("utf-8")
        got = nb.hop2_batch(queries, ids, high_df_blob=blob)
        for b in range(len(queries)):
            assert raw[b] is not None and got[b] is not None
            want = [prune_query(v, high_df) for v in raw[b]]
            assert got[b] == want, (queries[b], high_df, got[b], want)


def test_iterative_prepruned_dispatch_bit_parity():
    """iterative_retrieve over a pruning engine returns bit-identical ids
    and scores whether hop-2 queries are pruned natively (prepruned
    dispatch) or by the engine (python path, native bridge disabled)."""
    import numpy as np
    import pytest

    from a_modular_rag_framework_tpu.modules.retrieval import multihop as mh

    eng, samples = _iterative_engine()
    if mh._native_bridge_for(eng.index, eng.index.corpus.docs) is None:
        pytest.skip("native lib unavailable")
    qs = [s["question"] for s in samples[:16]]

    ids_n, sc_n, _, diag_n = mh.iterative_retrieve(eng, qs, top_k=10)

    # force the Python path: gate the native bridge off for this index
    mh._NATIVE_BRIDGES[eng.index] = None
    # drop memoized per-engine state so the python path re-derives it
    eng._mh_doc_runs = (eng.index, {})
    try:
        ids_p, sc_p, _, diag_p = mh.iterative_retrieve(eng, qs, top_k=10)
    finally:
        del mh._NATIVE_BRIDGES[eng.index]

    assert diag_n["hop2_queries"] != [] and diag_p["hop2_queries"] != []
    np.testing.assert_array_equal(np.asarray(ids_n), np.asarray(ids_p))
    np.testing.assert_array_equal(np.asarray(sc_n), np.asarray(sc_p))


def _iterative_engine():
    """Small CPU engine with idf pruning active (high_df_terms non-empty)."""
    from a_modular_rag_framework_tpu.core.dataset_loader import (
        SyntheticHotpotQALoader,
    )
    from a_modular_rag_framework_tpu.engine.query_engine import (
        EngineConfig,
        QueryEngine,
    )
    from a_modular_rag_framework_tpu.index.builder import build_packed_index
    from a_modular_rag_framework_tpu.index.corpus import SentenceCorpus

    samples = SyntheticHotpotQALoader({"count": 48, "seed": 3,
                                       "collide_entities": True}).load()
    corpus = SentenceCorpus.from_hotpotqa(samples)
    idx = build_packed_index(corpus)
    eng = QueryEngine(idx, config=EngineConfig(
        batch_buckets=(16,), query_df_ratio_max=0.05))
    assert eng._high_df_terms, "pruning must be active for this test"
    return eng, samples


def test_encoder_tokens_native_bit_exact():
    """Native TextEncoder featurization == the Python encode_tokens loop
    (models/encoder.py) for every subword_ngrams mode, including unicode
    lowercasing, short words, and the max_len cap."""
    from a_modular_rag_framework_tpu.models.encoder import (
        EncoderConfig,
        encode_tokens,
    )
    from a_modular_rag_framework_tpu.native.binding import (
        encoder_tokens_native,
    )

    texts = [
        "Aldenkel Torselbar collaborated closely with Fenwyn Ravkelsel.",
        "a", "", "X y2 Zq-wort 123 ABC", "Kelvin KKa sign",
        " ".join(f"w{i}" for i in range(50)),  # beyond the max_len cap
    ]
    for G in (1, 4, 8):
        cfg = EncoderConfig(subword_ngrams=G, max_len=32)
        nat = encoder_tokens_native(texts, cfg.max_len, cfg.vocab_size, G,
                                    cfg.ngram_min, cfg.ngram_max)
        if nat is None:
            pytest.skip("native library unavailable")
        # per-text calls stay under the fast-path threshold -> Python loop
        py = [encode_tokens([t], cfg) for t in texts]
        py_ids = np.concatenate([p[0] for p in py])
        py_mask = np.concatenate([p[1] for p in py])
        assert np.array_equal(py_ids, nat[0])
        assert np.array_equal(py_mask, nat[1])


def test_encode_tokens_fast_path_matches_loop():
    """encode_tokens >=64-text batches (native fast path) == the same call
    split into sub-threshold chunks (Python loop)."""
    from a_modular_rag_framework_tpu.models.encoder import (
        EncoderConfig,
        encode_tokens,
    )

    cfg = EncoderConfig(subword_ngrams=8, max_len=16)
    texts = [f"Person {i} worked in City{i % 7} as employee {i*3}."
             for i in range(80)]
    ids_big, mask_big = encode_tokens(texts, cfg)
    ids_sm = np.concatenate([encode_tokens(texts[i:i + 10], cfg)[0]
                             for i in range(0, 80, 10)])
    mask_sm = np.concatenate([encode_tokens(texts[i:i + 10], cfg)[1]
                              for i in range(0, 80, 10)])
    assert np.array_equal(ids_big, ids_sm)
    assert np.array_equal(mask_big, mask_sm)
