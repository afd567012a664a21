"""Packed index: build, save/load round-trip, checksums, device residency."""
import json

import numpy as np
import pytest

from a_modular_rag_framework_tpu.core.dataset_loader import SyntheticHotpotQALoader
from a_modular_rag_framework_tpu.index.builder import build_packed_index, build_sentence_graph
from a_modular_rag_framework_tpu.index.corpus import (
    SentenceCorpus,
    flatten_hotpotqa_context,
    read_docs_jsonl,
)
from a_modular_rag_framework_tpu.index.packed import PackedIndex
from a_modular_rag_framework_tpu.models.hash_embed import hash_embed_numpy


@pytest.fixture(scope="module")
def corpus():
    samples = SyntheticHotpotQALoader({"count": 12, "seed": 3}).load()
    return SentenceCorpus.from_hotpotqa(samples)


def test_flatten_schema_and_dedup():
    samples = SyntheticHotpotQALoader({"count": 4, "seed": 1}).load()
    docs = list(flatten_hotpotqa_context(samples + samples))  # repeat -> dedup
    assert docs == list(flatten_hotpotqa_context(samples))
    d = docs[0]
    assert set(d) == {"doc_id", "title", "sent_id", "text"}
    assert d["doc_id"] == f"{d['title']}#{d['sent_id']}"


def test_sentence_graph_next_in_doc_and_entity_links(corpus):
    tables = build_sentence_graph(corpus, max_degree=16)
    nxt_t, ent_t = tables["next_in_doc"], tables["entity"]
    assert nxt_t.shape[1] == 2 and ent_t.shape[1] == 16
    by = corpus.row_by_title_sid()
    # next-in-doc chain present
    d0 = corpus.docs[0]
    nxt = by.get((d0["title"], d0["sent_id"] + 1))
    if nxt is not None:
        assert nxt in nxt_t[0].tolist()
    # symmetry: every edge appears in both rows (up to degree cap)
    for tbl in (nxt_t, ent_t):
        for a in range(min(20, len(corpus))):
            for b in tbl[a]:
                if b >= 0:
                    assert a in tbl[b].tolist()


def test_build_save_load_roundtrip(tmp_path, corpus):
    idx = build_packed_index(corpus, embed_dim=32, embed_dtype="float32",
                             out_dir=str(tmp_path / "idx"))
    loaded = PackedIndex.load(tmp_path / "idx", verify_checksums=True)
    assert loaded.n_docs == idx.n_docs == len(corpus)
    np.testing.assert_allclose(np.asarray(loaded.embeddings), idx.embeddings, rtol=1e-6)
    np.testing.assert_array_equal(loaded.graph_next, idx.graph_next)
    np.testing.assert_array_equal(loaded.graph_entity, idx.graph_entity)
    np.testing.assert_array_equal(loaded.bm25.row_ptr, idx.bm25.row_ptr)
    assert loaded.bm25.vocab == idx.bm25.vocab
    # embeddings match the host hash-embed oracle
    want = hash_embed_numpy(corpus.texts()[:5], dim=32)
    np.testing.assert_allclose(np.asarray(loaded.embeddings)[:5], want, atol=1e-5)
    # build stats recorded
    stats = loaded.manifest["build_stats"]
    assert stats["passages"] == len(corpus) and stats["passages_per_sec"] > 0


def test_bf16_storage_roundtrip(tmp_path, corpus):
    idx = build_packed_index(corpus, embed_dim=32, embed_dtype="bfloat16",
                             out_dir=str(tmp_path / "idx16"))
    loaded = PackedIndex.load(tmp_path / "idx16")
    dev = loaded.device_embeddings()
    assert str(dev.dtype) == "bfloat16"
    # bf16 rounding error is bounded (values are L2-normalized, |x| <= 1)
    err = np.abs(np.asarray(dev, dtype=np.float32) - idx.embeddings.astype(np.float32))
    assert err.max() < 0.01
    # save the loaded (uint16) index again -> identical bytes semantics
    loaded.save(tmp_path / "idx16b")
    again = PackedIndex.load(tmp_path / "idx16b")
    np.testing.assert_array_equal(np.asarray(again.embeddings), np.asarray(loaded.embeddings))


def test_checksum_verification_detects_corruption(tmp_path, corpus):
    build_packed_index(corpus, embed_dim=16, out_dir=str(tmp_path / "idx"))
    p = tmp_path / "idx" / "bm25_df.npy"
    data = bytearray(p.read_bytes())
    data[-1] ^= 0xFF
    p.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="checksum mismatch"):
        PackedIndex.load(tmp_path / "idx", verify_checksums=True)
    # without verification it loads (mmap path must not crash)
    PackedIndex.load(tmp_path / "idx", verify_checksums=False)


def test_corpus_hit_hydration(corpus):
    hid = corpus.hit_id(0)
    assert hid.startswith("sent::") and hid.endswith(f"::{corpus.docs[0]['sent_id']}")
    meta = corpus.hit_meta(0)
    assert meta["kind"] == "sentence" and meta["text"] == corpus.docs[0]["text"]


def test_docs_jsonl_missing_file_returns_empty(tmp_path):
    assert read_docs_jsonl(tmp_path / "nope.jsonl") == []


def test_phrase_tokens_rescue_colliding_names():
    """Full-name phrase tokens (hash_embed.phrase_augment, indexed by
    default) make the near-unique entity phrase a BM25 term: on a
    colliding-name corpus (factored pools — every first/surname token
    shared across many people) the gold docs must rank despite hundreds
    of token-level collisions."""
    import numpy as np

    from a_modular_rag_framework_tpu.core.dataset_loader import (
        SyntheticHotpotQALoader,
    )
    from a_modular_rag_framework_tpu.engine.query_engine import (
        EngineConfig,
        QueryEngine,
    )
    from a_modular_rag_framework_tpu.eval.harness import (
        evaluate_retrieval,
    )
    from a_modular_rag_framework_tpu.index.builder import build_packed_index
    from a_modular_rag_framework_tpu.index.corpus import SentenceCorpus

    samples = SyntheticHotpotQALoader(
        {"count": 48, "seed": 2, "n_distractors": 8,
         "collide_entities": True, "first_pool": 64, "last_pool": 128}).load()
    corpus = SentenceCorpus.from_hotpotqa(samples)
    # term_topm=4 emulates fullwiki-scale posting truncation: each name
    # token's list greatly exceeds the phase-1 window, so token-level
    # matching alone cannot surface the gold docs (ties broken
    # arbitrarily) — the regime where the near-unique phrase token's
    # short posting list is the rescue
    cfg = EngineConfig(top_k=10, pool_k=64, graph_window=2,
                       batch_buckets=(48,), query_df_ratio_max=0.05,
                       bm25_term_topm=4)
    idx_plain = build_packed_index(corpus, embed_dim=32,
                                   bm25_phrase_tokens=False)
    idx_phrase = build_packed_index(corpus, embed_dim=32)
    from a_modular_rag_framework_tpu.eval.harness import gold_hit_ids
    from a_modular_rag_framework_tpu.eval.metrics import recall_at_k
    from a_modular_rag_framework_tpu.modules.retrieval.multihop import (
        iterative_retrieve,
    )

    qs = [s["question"] for s in samples]

    def both_recalls(idx):
        eng = QueryEngine(idx, config=cfg)
        r1 = evaluate_retrieval(eng, samples, k=10, batch_size=48)
        ids = np.asarray(iterative_retrieve(eng, qs, top_k=10)[0])
        recs = [recall_at_k([eng.index.corpus.hit_id(int(i))
                             for i in ids[row] if i >= 0],
                            gold_hit_ids(s), 10)
                for row, s in enumerate(samples)]
        return r1["recall_at_10"], float(np.mean(recs))

    plain_1, plain_it = both_recalls(idx_plain)
    phrase_1, phrase_it = both_recalls(idx_phrase)
    # measured: plain 0.021/0.021 vs phrase 0.52/0.99 — the phrase term's
    # ~4-entry posting list always fits the window, so the gold docs are
    # guaranteed pool members while token postings truncate arbitrarily
    assert phrase_1 > plain_1 + 0.3, (plain_1, phrase_1)
    assert phrase_it > plain_it + 0.5, (plain_it, phrase_it)
    assert phrase_it >= 0.9
