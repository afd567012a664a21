"""Cross-encoder reranker: model, training, persistence, backend stage."""
import numpy as np
import pytest

from a_modular_rag_framework_tpu.models.cross_encoder import (
    CrossEncoderConfig,
    CrossEncoderReranker,
    encode_pairs,
    make_cross_train_step,
)

CFG = CrossEncoderConfig(vocab_size=512, max_len=24, max_query_len=8,
                         d_model=32, n_heads=2, n_layers=1, d_ff=64,
                         subword_ngrams=2)


def test_encode_pairs_layout():
    ids, mask, seg = encode_pairs(
        ["who wrote it", ""], ["The Book was written by Ann Li.", "x"], CFG)
    assert ids.shape[:2] == (2, 24) and seg.shape == (2, 24)
    # query occupies [0, max_query_len), passage after; segments split there
    assert (seg[:, :8] == 0).all() and (seg[:, 8:] == 1).all()
    assert mask[0, :3].all() and mask[0, 3:8].sum() == 0  # 3 query tokens
    assert mask[0, 8:].sum() > 0  # passage tokens present
    assert mask[1, :8].sum() == 0  # empty query row


def test_scores_deterministic_and_chunked_equal():
    r = CrossEncoderReranker(CFG, seed=1, pair_budget=4)
    qs = [f"who is person {i}" for i in range(10)]
    ps = [f"Person {i} lives in Town {i}." for i in range(10)]
    s1 = r.score_pairs(qs, ps)
    r2 = CrossEncoderReranker(CFG, params=r.params, pair_budget=64)
    s2 = r2.score_pairs(qs, ps)
    np.testing.assert_allclose(s1, s2, atol=1e-5)  # chunking is invisible


def test_training_learns_relevance():
    """A few listwise steps must lift ranking accuracy far above the 1/M
    chance level on a learnable synthetic relation."""
    import jax

    rng = np.random.default_rng(0)
    names = [f"name{i}" for i in range(40)]
    towns = [f"town{i}" for i in range(40)]
    queries, lists, labels = [], [], []
    for i in range(40):
        q = f"where does {names[i]} live"
        pos = f"{names[i]} lives in {towns[i]}."
        negs = [f"{names[j]} lives in {towns[j]}."
                for j in rng.choice([x for x in range(40) if x != i], 3,
                                    replace=False)]
        slot = int(rng.integers(4))
        queries.append(q)
        lists.append(negs[:slot] + [pos] + negs[slot:])
        labels.append(slot)
    r = CrossEncoderReranker(CFG, seed=0)
    init_state, train_step = make_cross_train_step(CFG, 3e-3)
    step = jax.jit(train_step, donate_argnums=(0, 1))
    params, opt = r.params, init_state(r.params)
    batch = CrossEncoderReranker.make_listwise_batch(queries, lists, labels,
                                                     CFG)
    acc0 = None
    for it in range(60):
        params, opt, m = step(params, opt, batch)
        if acc0 is None:
            acc0 = float(m["accuracy"])
    assert float(m["accuracy"]) >= 0.9, (acc0, float(m["accuracy"]))
    # and the trained model reranks a shuffled candidate list correctly
    r.params = params
    order = r.rerank("where does name3 live",
                     [f"{names[j]} lives in {towns[j]}." for j in
                      (7, 3, 12, 30)])
    assert order[0] == 1


def test_save_load_roundtrip(tmp_path):
    r = CrossEncoderReranker(CFG, seed=2)
    s1 = r.score_pairs(["a b"], ["c d e"])
    p = tmp_path / "ce.npz"
    r.save(str(p))
    r2 = CrossEncoderReranker.load(str(p), CFG)
    np.testing.assert_allclose(s1, r2.score_pairs(["a b"], ["c d e"]),
                               atol=1e-6)
    with pytest.raises(ValueError):
        CrossEncoderReranker.load(
            str(p), CrossEncoderConfig(vocab_size=512, max_len=24,
                                       max_query_len=8, d_model=64))


def test_backend_cross_rerank_stage(tmp_path):
    """EngineRetrievalBackend with cross_rerank_weights reorders its
    top-m by cross-encoder score and records the stage in diagnostics;
    hit SET is unchanged vs the same backend without reranking."""
    from a_modular_rag_framework_tpu.core.dataset_loader import (
        SyntheticHotpotQALoader,
    )
    from a_modular_rag_framework_tpu.core.dto import RetrievalIn
    from a_modular_rag_framework_tpu.index.builder import build_packed_index
    from a_modular_rag_framework_tpu.index.corpus import SentenceCorpus
    from a_modular_rag_framework_tpu.modules.retrieval.engine_backend import (
        EngineRetrievalBackend,
    )

    samples = SyntheticHotpotQALoader({"count": 24, "seed": 5}).load()
    idx = build_packed_index(SentenceCorpus.from_hotpotqa(samples))
    w = tmp_path / "ce.npz"
    # the constructor loads with the DEFAULT architecture (only
    # subword_ngrams is configurable there) — save a matching checkpoint
    ship_cfg = CrossEncoderConfig(subword_ngrams=2)
    CrossEncoderReranker(ship_cfg, seed=3).save(str(w))

    base = EngineRetrievalBackend(index=idx, batch_buckets=(8,),
                                     iterative_hops=1)
    rer = EngineRetrievalBackend(index=idx, batch_buckets=(8,),
                                    iterative_hops=1,
                                    cross_rerank_weights=str(w),
                                    cross_rerank_top_m=10,
                                    cross_rerank_subword_ngrams=2)

    req = RetrievalIn(query=samples[0]["question"], top_k=10,
                      trace_id="t-ce")
    out0 = base.retrieve(req)
    out1 = rer.retrieve(req)
    assert out1.diagnostics.get("cross_reranked") == 10
    assert {h.id for h in out0.hits} == {h.id for h in out1.hits}
    scores = [h.meta.get("cross_score") for h in out1.hits]
    got = [s for s in scores if s is not None]
    assert got == sorted(got, reverse=True) and len(got) >= 1
