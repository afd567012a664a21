"""Telemetry device-timing events, engine reload, packed-index engine reuse."""
import json

import numpy as np

from a_modular_rag_framework_tpu.core.dataset_loader import SyntheticHotpotQALoader
from a_modular_rag_framework_tpu.engine.query_engine import EngineConfig, QueryEngine
from a_modular_rag_framework_tpu.index.builder import build_packed_index
from a_modular_rag_framework_tpu.index.corpus import SentenceCorpus
from a_modular_rag_framework_tpu.index.packed import PackedIndex
from a_modular_rag_framework_tpu.telemetry.sinks import (
    LocalJsonlSink,
    build_latency_breakdown,
)


def _small_index():
    samples = SyntheticHotpotQALoader({"count": 6, "seed": 13}).load()
    corpus = SentenceCorpus.from_hotpotqa(samples)
    return build_packed_index(corpus, embed_dim=32, embed_dtype="float32"), samples


def test_engine_emits_device_timing(tmp_path):
    idx, samples = _small_index()
    sink = LocalJsonlSink(root_dir=str(tmp_path))
    engine = QueryEngine(idx, config=EngineConfig(top_k=5, batch_buckets=(1,)),
                            sink=sink)
    engine.query_batch([samples[0]["question"]], trace_id="tr-dev")
    evts = [json.loads(l) for l in
            (tmp_path / "tr-dev" / "events.jsonl").read_text().splitlines()]
    timing = [e for e in evts if e["event"] == "device_timing"]
    assert timing and timing[0]["payload"]["device_ms"] > 0
    lb = build_latency_breakdown(evts)
    assert "device_ms_by_kernel" in lb


def test_engine_reload_preserves_results():
    idx, samples = _small_index()
    engine = QueryEngine(idx, config=EngineConfig(top_k=5, batch_buckets=(1,)))
    q = samples[0]["question"]
    before = np.asarray(engine.query_batch([q]).hits.ids)
    engine.reload()
    after = np.asarray(engine.query_batch([q]).hits.ids)
    np.testing.assert_array_equal(before, after)


def test_engine_from_reloaded_packed_index(tmp_path):
    """Persist -> memory-map -> serve: the checkpoint-as-index contract."""
    idx, samples = _small_index()
    idx.save(tmp_path / "idx")
    loaded = PackedIndex.load(tmp_path / "idx", mmap=True)
    e1 = QueryEngine(idx, config=EngineConfig(top_k=5, batch_buckets=(1,)))
    e2 = QueryEngine(loaded, config=EngineConfig(top_k=5, batch_buckets=(1,)))
    q = samples[1]["question"]
    a = np.asarray(e1.query_batch([q]).hits.ids)
    b = np.asarray(e2.query_batch([q]).hits.ids)
    np.testing.assert_array_equal(a, b)
