"""Real-HotpotQA-schema path, end to end (VERDICT r2 missing item 1).

The reference's whole data path runs on real HotpotQA
(/root/reference/my_code/ingest_hotpotqa.py:46-87, my_code/run_system.py:
13-66), but the actual dataset is unobtainable here (no network —
BASELINE.md). This fixture is 5 hand-written samples in the EXACT real
schema — array-of-objects JSON, {_id, question, answer, type, level,
supporting_facts: [[title, sent_id]...], context: [[title, [sent...]]...]},
leading-space continuation sentences, parenthesised titles, diacritics,
a comparison-type question — driven through the one chain a release-day
user exercises: HotpotQALoader -> ingest (graphs + docs.jsonl + packed
index) -> settings -> answer_question.
"""
from __future__ import annotations

import json
from pathlib import Path

import pytest

FIXTURE = Path(__file__).parent / "fixtures" / "hotpotqa_real_schema.json"
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def loaded_samples():
    from a_modular_rag_framework_tpu.core.dataset_loader import (
        build_dataset_loader,
    )

    loader = build_dataset_loader(
        {"type": "hotpotqa", "path": str(FIXTURE), "count": -1})
    return loader.load()


def test_hotpotqa_loader_parses_real_schema(loaded_samples):
    assert len(loaded_samples) == 5
    s = loaded_samples[0]
    assert s["question"].startswith("In which city")
    assert s["supporting_facts"] == [["Jaws (film)", 0],
                                     ["Steven Spielberg", 0]]
    assert s["context"][0][0] == "Jaws (film)"
    # index/count slicing (reference dataset_loader.py semantics)
    from a_modular_rag_framework_tpu.core.dataset_loader import HotpotQALoader
    sl = HotpotQALoader({"path": str(FIXTURE), "index": 2, "count": 2}).load()
    assert [x["_id"] for x in sl] == [loaded_samples[2]["_id"],
                                      loaded_samples[3]["_id"]]


@pytest.fixture(scope="module")
def ingested(loaded_samples, tmp_path_factory):
    from a_modular_rag_framework_tpu.cli.ingest_hotpotqa import ingest

    work = tmp_path_factory.mktemp("real_schema")
    docs_out = work / "docs.jsonl"
    stats = ingest(loaded_samples, graph_root=work / "graph",
                   docs_out=docs_out)
    return work, docs_out, stats


def test_ingest_real_schema_corpus(ingested, loaded_samples):
    work, docs_out, stats = ingested
    n_sents = sum(len(sents) for s in loaded_samples
                  for _, sents in s["context"])
    assert stats["sentences"] == n_sents
    # docs.jsonl rows carry the reference schema {doc_id, title, sent_id,
    # text} (reference my_code/ingest_hotpotqa.py:73-81)
    rows = [json.loads(l) for l in docs_out.read_text().splitlines()]
    assert {"doc_id", "title", "sent_id", "text"} <= set(rows[0])
    assert any(r["title"] == "Pablo Picasso" and "Málaga" in r["text"]
               for r in rows)
    # per-sample supporting-fact graphs persisted
    graphs = list((work / "graph").glob("hotpotqa-*/graph.json"))
    assert len(graphs) == 5


@pytest.fixture(scope="module")
def real_settings(ingested):
    work, docs_out, _ = ingested
    settings = json.loads((ROOT / "config" / "settings.json").read_text())
    rk = settings["modules"]["retrieval"].setdefault("impl_kwargs", {})
    rk["index_path"] = str(docs_out)
    rk["graph_root"] = str(work / "graph")
    settings["dataset"] = {"type": "hotpotqa", "path": str(FIXTURE),
                           "count": -1}
    s_path = work / "settings.json"
    s_path.write_text(json.dumps(settings))
    return s_path


def test_retrieval_finds_supporting_facts(ingested, loaded_samples):
    """The engine itself (no LLM in the loop) recalls the gold sentences
    of every fixture question."""
    from a_modular_rag_framework_tpu.engine.query_engine import (
        EngineConfig,
        QueryEngine,
    )
    from a_modular_rag_framework_tpu.eval.harness import (
        evaluate_retrieval,
        gold_hit_ids,
    )
    from a_modular_rag_framework_tpu.index.packed import PackedIndex

    import numpy as np

    from a_modular_rag_framework_tpu.eval.metrics import recall_at_k
    from a_modular_rag_framework_tpu.modules.retrieval.multihop import (
        iterative_retrieve,
    )

    _, docs_out, stats = ingested
    idx = PackedIndex.load(stats["packed_dir"])
    engine = QueryEngine(idx, config=EngineConfig(
        top_k=10, pool_k=32, graph_window=2, batch_buckets=(8,)))
    # single-pass finds the hop-1 facts; the iterative bridge-entity mode
    # (the production quality mode) must recall everything
    q = evaluate_retrieval(engine, loaded_samples, k=10, batch_size=8)
    assert q["recall_at_10"] >= 0.6
    out = iterative_retrieve(engine, [s["question"] for s in loaded_samples],
                             top_k=10)
    ids = np.asarray(out[0])
    recalls = []
    for row, s in enumerate(loaded_samples):
        got = [engine.index.corpus.hit_id(int(i)) for i in ids[row] if i >= 0]
        recalls.append(recall_at_k(got, gold_hit_ids(s), 10))
    assert float(np.mean(recalls)) == 1.0
    assert gold_hit_ids(loaded_samples[0]) == [
        "sent::Jaws (film)::0", "sent::Steven Spielberg::0"]


def test_answer_question_end_to_end_on_real_schema(real_settings,
                                                   loaded_samples):
    """Full workflow over the real-schema corpus: every question completes
    with a verdict; the bridge questions (the family the mock synthesizer's
    span extraction covers) answer exactly."""
    from a_modular_rag_framework_tpu.eval.metrics import exact_match
    from a_modular_rag_framework_tpu.system import answer_question

    bridge_em = []
    for s in loaded_samples:
        res = answer_question(s["question"], mode="full",
                              settings_path=str(real_settings))
        assert res["verification"]["verdict"], s["question"]
        answer = (res.get("reasoning") or {}).get("answer") or ""
        assert answer.strip(), s["question"]
        if s["type"] == "bridge":
            bridge_em.append(exact_match(answer, s["answer"]))
    # 4 bridge questions; demand at least 3 exact (one may fall to the
    # comparison-style fallback path)
    assert sum(bridge_em) >= 3, bridge_em
