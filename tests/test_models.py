"""Encoder model: forward determinism, training step learns, sharded step
runs on the 8-device CPU mesh with tp/dp shardings."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from a_modular_rag_framework_tpu.core.dataset_loader import SyntheticHotpotQALoader
from a_modular_rag_framework_tpu.models.encoder import (
    EncoderConfig,
    TextEncoder,
    apply_encoder,
    encode_tokens,
    info_nce_loss,
    init_params,
    make_train_step,
    param_partition_specs,
    shard_train_step,
)
from a_modular_rag_framework_tpu.parallel.mesh import build_mesh

CFG = EncoderConfig(vocab_size=512, max_len=16, d_model=32, n_heads=2,
                    n_layers=2, d_ff=64)


def test_encoder_forward_shapes_and_norm():
    enc = TextEncoder(CFG, seed=0)
    out = enc.encode_texts(["hello world", "a much longer sentence about cats"])
    assert out.shape == (2, 32)
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, rtol=1e-4)
    # deterministic
    out2 = TextEncoder(CFG, seed=0).encode_texts(["hello world",
                                                  "a much longer sentence about cats"])
    np.testing.assert_allclose(out, out2, rtol=1e-5)
    # padding-independent: same text alone or batched
    np.testing.assert_allclose(out[0], enc.encode_texts(["hello world"])[0],
                               rtol=1e-4, atol=1e-5)


def test_encoder_mask_excludes_padding():
    params = init_params(jax.random.PRNGKey(0), CFG)
    ids, mask = encode_tokens(["tiny"], CFG)
    out1 = apply_encoder(params, jnp.asarray(ids), jnp.asarray(mask), CFG)
    # corrupt padded positions; output must not change
    ids2 = ids.copy()
    ids2[0, 5:] = 7
    out2 = apply_encoder(params, jnp.asarray(ids2), jnp.asarray(mask), CFG)
    np.testing.assert_allclose(np.asarray(out1), np.asarray(out2), atol=1e-5)


def test_train_step_reduces_loss():
    samples = SyntheticHotpotQALoader({"count": 16, "seed": 2}).load()
    queries = [s["question"] for s in samples]
    passages = [s["context"][0][1][0] for s in samples]
    batch = {k: jnp.asarray(v) for k, v in
             TextEncoder.make_pair_batch(queries, passages, CFG).items()}

    params = init_params(jax.random.PRNGKey(1), CFG)
    init_state, train_step = make_train_step(CFG, learning_rate=3e-3)
    opt_state = init_state(params)
    step = jax.jit(train_step)

    loss0 = float(info_nce_loss(params, batch, CFG)[0])
    for _ in range(20):
        params, opt_state, metrics = step(params, opt_state, batch)
    loss1 = float(metrics["loss"])
    assert loss1 < loss0 * 0.8, (loss0, loss1)


def test_sharded_train_step_runs_on_mesh():
    mesh = build_mesh({"data": 4, "model": 2})
    params = init_params(jax.random.PRNGKey(0), CFG)

    place_params, place_batch, init_state, step = shard_train_step(CFG, mesh)
    params = place_params(params)
    opt_state = init_state(params)

    samples = SyntheticHotpotQALoader({"count": 8, "seed": 4}).load()
    batch = place_batch({k: jnp.asarray(v) for k, v in TextEncoder.make_pair_batch(
        [s["question"] for s in samples],
        [s["context"][0][1][0] for s in samples], CFG).items()})

    params2, opt_state, metrics = step(params, opt_state, batch)
    assert np.isfinite(float(metrics["loss"]))
    # params actually sharded over the model axis
    wqkv = params2["layers"][0]["wqkv"]
    assert "model" in str(wqkv.sharding.spec)


def test_partition_specs_cover_params():
    params = init_params(jax.random.PRNGKey(0), CFG)
    specs = param_partition_specs(CFG)
    jax.tree.map(lambda p, s: None, params, specs,
                 is_leaf=lambda x: isinstance(x, jax.Array) or hasattr(x, "shape"))


def test_backend_loads_trained_encoder_weights(tmp_path):
    """encoder_weights config plugs a trained TextEncoder into the backend
    (same encoder embeds the corpus at build and the queries at runtime)."""
    import jax

    from a_modular_rag_framework_tpu.core.dto import RetrievalIn
    from a_modular_rag_framework_tpu.index.builder import build_packed_index
    from a_modular_rag_framework_tpu.index.corpus import SentenceCorpus, write_docs_jsonl
    from a_modular_rag_framework_tpu.modules.retrieval.engine_backend import (
        EngineRetrievalBackend,
    )
    from a_modular_rag_framework_tpu.models.encoder import EncoderConfig, TextEncoder

    cfg = EncoderConfig(d_model=32, n_layers=1)
    enc = TextEncoder(cfg, seed=5)
    weights = tmp_path / "enc.npz"
    enc.save(str(weights))

    samples = SyntheticHotpotQALoader({"count": 4, "seed": 6}).load()
    corpus = SentenceCorpus.from_hotpotqa(samples)
    docs = tmp_path / "docs.jsonl"
    write_docs_jsonl(corpus.docs, docs)

    backend = EngineRetrievalBackend(
        index_path=str(docs), embed_dim=32, encoder_weights=str(weights),
        encoder_layers=1, iterative_hops=1,
    )
    assert isinstance(backend.engine.encoder, TextEncoder)
    out = backend.retrieve(RetrievalIn(query=samples[0]["question"],
                                       graph_id="", top_k=5, trace_id="t"))
    assert out.hits
