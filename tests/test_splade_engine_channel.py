"""SPLADE as the hybrid engine's text channel (EngineConfig.sparse_impl).

Parity contract: with graph/dense alphas zeroed and exact windows
(term_topm >= n_docs), the engine's text channel must rank exactly like the
standalone `SpladeRetriever` over the same corpus — the engine adds the
pool-k + exact-rescore machinery, which is a no-op when phase 1 is exact.
"""
import numpy as np
import pytest

from a_modular_rag_framework_tpu.core.dataset_loader import (
    SyntheticHotpotQALoader,
)
from a_modular_rag_framework_tpu.engine.query_engine import (
    EngineConfig,
    QueryEngine,
)
from a_modular_rag_framework_tpu.index.builder import build_packed_index
from a_modular_rag_framework_tpu.index.corpus import SentenceCorpus
from a_modular_rag_framework_tpu.models.encoder import EncoderConfig
from a_modular_rag_framework_tpu.models.splade import (
    SpladeConfig,
    SpladeEncoder,
)
from a_modular_rag_framework_tpu.ops.splade import SpladeRetriever


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    samples = SyntheticHotpotQALoader(
        {"count": 12, "seed": 3, "unique_entities": True}).load()
    corpus = SentenceCorpus.from_hotpotqa(samples)
    idx = build_packed_index(corpus, embed_dim=16, embed_dtype="float32")
    cfg = SpladeConfig(
        encoder=EncoderConfig(vocab_size=2048, d_model=32, n_heads=2,
                              n_layers=1, max_len=16, subword_ngrams=1),
        doc_top_terms=32, query_top_terms=8)
    enc = SpladeEncoder(cfg, seed=7)
    ckpt = tmp_path_factory.mktemp("splade") / "sp.npz"
    enc.save(str(ckpt))
    return samples, corpus, idx, enc, str(ckpt)


def test_engine_splade_channel_matches_retriever(setup):
    samples, corpus, idx, enc, ckpt = setup
    r = SpladeRetriever(enc, term_topm=256)
    r.build(corpus.texts())
    qs = [s["question"] for s in samples[:8]]
    ids_ref, scores_ref = r.query_batch(qs, top_k=5)

    engine = QueryEngine(idx, config=EngineConfig(
        sparse_impl="splade", splade_weights=ckpt, top_k=5,
        pool_k=64, alpha_text=1.0, alpha_graph=0.0, alpha_dense=0.0,
        graph_window=1, batch_buckets=(8,), bm25_term_topm=256))
    res = engine.query_batch(qs)
    ids_eng = np.asarray(res.hits.ids)
    for row in range(len(qs)):
        ref = [int(i) for i, s in zip(ids_ref[row], scores_ref[row])
               if i >= 0 and s > 0]
        assert [int(i) for i in ids_eng[row][:len(ref)]] == ref, f"row {row}"


def test_engine_splade_full_hybrid_runs_and_caches_programs(setup):
    samples, corpus, idx, enc, ckpt = setup
    engine = QueryEngine(idx, config=EngineConfig(
        sparse_impl="splade", splade_weights=ckpt, top_k=5,
        pool_k=32, graph_window=2, batch_buckets=(8,),
        bm25_term_topm=64))
    qs = [s["question"] for s in samples[:8]]
    r1 = engine.query_batch(qs)
    assert np.asarray(r1.hits.ids).shape == (8, 5)
    # second call reuses the compiled program (same key)
    n_programs = len(engine._jit_cache)
    r2 = engine.query_batch(qs)
    assert len(engine._jit_cache) == n_programs
    assert np.array_equal(np.asarray(r1.hits.ids), np.asarray(r2.hits.ids))
    # hop-2-style variant expansion rides the same splade path (E > 1)
    r3 = engine.query_batch(qs, expansions=[[q] for q in qs])
    assert np.asarray(r3.hits.ids).shape == (8, 5)


def test_engine_splade_config_validation(setup):
    samples, corpus, idx, enc, ckpt = setup
    with pytest.raises(ValueError, match="splade_weights"):
        QueryEngine(idx, config=EngineConfig(sparse_impl="splade"))
    with pytest.raises(ValueError, match="sorted"):
        QueryEngine(idx, config=EngineConfig(
            sparse_impl="splade", splade_weights=ckpt,
            bm25_impl="scatter"))
    with pytest.raises(ValueError, match="sparse_impl"):
        QueryEngine(idx, config=EngineConfig(sparse_impl="typo"))


def test_rescore_pool_term_weights_oracle():
    """bm25_rescore_pool's term_weights seam == numpy weighted sum."""
    import jax.numpy as jnp

    from a_modular_rag_framework_tpu.ops.bm25 import bm25_rescore_pool

    rng = np.random.default_rng(0)
    N, D, B, E, T, K = 20, 6, 3, 2, 4, 5
    doc_terms = rng.integers(0, 30, size=(N, D)).astype(np.int32)
    doc_terms[:, -2:] = -2  # padding
    doc_scores = rng.random((N, D)).astype(np.float32)
    doc_scores[doc_terms == -2] = 0.0
    term_ids = rng.integers(-1, 30, size=(B, E, T)).astype(np.int32)
    weights = rng.random((B, E, T)).astype(np.float32)
    pool_i = rng.integers(-1, N, size=(B, K)).astype(np.int32)

    got = np.asarray(bm25_rescore_pool(
        jnp.asarray(pool_i), jnp.asarray(term_ids),
        jnp.asarray(doc_terms), jnp.asarray(doc_scores), n_docs=N,
        term_weights=jnp.asarray(weights)))

    want = np.zeros((B, K), dtype=np.float32)
    for b in range(B):
        for ki in range(K):
            d = pool_i[b, ki]
            if d < 0:
                continue
            best = -np.inf
            for e in range(E):
                tot = 0.0
                for t in range(T):
                    tid = term_ids[b, e, t]
                    if tid < 0:
                        continue
                    tot += weights[b, e, t] * float(
                        doc_scores[d][doc_terms[d] == tid].sum())
                best = max(best, tot)
            want[b, ki] = best
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
