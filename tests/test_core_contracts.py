"""Tests for core DTOs, factory, router, providers, telemetry, datasets."""
import json

import numpy as np
import pytest

from a_modular_rag_framework_tpu.core.dto import Hit, HitBatch, RetrievalIn, VerifyOut
from a_modular_rag_framework_tpu.core.dataset_loader import (
    SyntheticHotpotQALoader,
    build_dataset_loader,
)
from a_modular_rag_framework_tpu.core.llm_router import LLMRouter
from a_modular_rag_framework_tpu.core.providers.mock_provider import MockProvider
from a_modular_rag_framework_tpu.di.factory import (
    build_providers,
    build_router,
    filtered_kwargs,
    import_from_string,
    parse_module_spec,
)
from a_modular_rag_framework_tpu.telemetry.sinks import (
    LocalJsonlSink,
    build_latency_breakdown,
    build_mermaid,
    span,
)


def test_hitbatch_hydrate_skips_padding():
    hb = HitBatch(
        ids=np.array([[2, 0, -1]], dtype=np.int32),
        scores=np.array([[0.9, 0.5, 0.0]], dtype=np.float32),
    )
    hits = hb.hydrate(0, id_fn=lambda i: f"sent::{i}", meta_fn=lambda i: {"row": i})
    assert [h.id for h in hits] == ["sent::2", "sent::0"]
    assert hits[0].meta["row"] == 2


def test_import_from_string_both_forms():
    cls1 = import_from_string("a_modular_rag_framework_tpu.core.dto:Hit")
    cls2 = import_from_string("a_modular_rag_framework_tpu.core.dto.Hit")
    assert cls1 is cls2 is Hit


@pytest.mark.parametrize("spec", [
    "a_modular_rag_framework_tpu.core.no_such_module:Hit",
    "a_modular_rag_framework_tpu.core.dto:NoSuchClass"])
def test_import_from_string_names_the_failing_entry(spec):
    with pytest.raises(ImportError, match="CHANGES.md") as e:
        import_from_string(spec)
    assert spec in str(e.value)


def test_parse_module_spec_three_forms():
    # string form
    spec, kw = parse_module_spec({"m": "pkg.mod:Cls"}, "m", "d:D")
    assert spec == "pkg.mod:Cls" and kw == {}
    # impl form
    spec, kw = parse_module_spec({"m": {"impl": "pkg.i:I", "kwargs": {"a": 1}}}, "m", "d:D")
    assert spec == "pkg.i:I" and kw["a"] == 1 and kw["impl"] == "pkg.i:I"
    # full form
    spec, kw = parse_module_spec(
        {"m": {"type": "pkg.f:F", "kwargs": {"x": 2}, "impl": "pkg.i:I", "impl_kwargs": {"y": 3}}},
        "m",
        "d:D",
    )
    assert spec == "pkg.f:F"
    assert kw == {"x": 2, "impl": "pkg.i:I", "impl_kwargs": {"y": 3}}
    # missing -> default
    spec, kw = parse_module_spec({}, "m", "d:D")
    assert spec == "d:D" and kw == {}


def test_filtered_kwargs_reflection():
    class Thing:
        def __init__(self, a, router=None):
            self.a, self.router = a, router

    out = filtered_kwargs(Thing, {"a": 1, "junk": 9}, inject={"router": "R", "sink": "S"})
    assert out == {"a": 1, "router": "R"}


def test_router_policy_selection_and_mock_fallback(tmp_path):
    sink = LocalJsonlSink(root_dir=str(tmp_path))
    policy = {
        "default": [{"model": "m0", "provider": "mock"}],
        "routes": {"ReasoningAgent": {"plan": [{"model": "m1", "provider": "mock"}]}},
        "embedding_provider": "mock",
    }
    router = LLMRouter(providers={"mock": MockProvider()}, policy=policy, sink=sink)

    dec = router.select("ReasoningAgent", "plan")
    assert dec.model == "m1"
    dec = router.select("ReasoningAgent", "unknown_purpose")
    assert dec.model == "m0"

    out = router.complete(
        module="ReasoningAgent",
        purpose="plan",
        prompt="You are a decomposition planner for multi-hop QA.\nQuestion: Where was Alice Smith born?\nDecompose",
        require={"trace_id": "t1"},
    )
    assert "1)" in out["text"]

    vecs = router.embed(texts=["hello world", "hello world"], require={"trace_id": "t1"})
    assert len(vecs) == 2 and vecs[0] == vecs[1]

    events = (tmp_path / "t1" / "events.jsonl").read_text().strip().splitlines()
    kinds = [json.loads(e)["event"] for e in events]
    assert kinds.count("llm_call") == 2


def test_router_no_policy_degrades_to_mock():
    router = LLMRouter(providers={}, policy={})
    out = router.complete(module="X", purpose="y", prompt="hi")
    assert out["text"]
    assert out["_fallback_reason"] in ("no_policy", "no_provider")


def test_mock_provider_synthesize_picks_best_citation():
    mp = MockProvider()
    prompt = (
        "Synthesize a final answer using ONLY the provided citations. "
        "Cite evidence inline using [#k].\n\nPlan:\nStep 1: x\n\nCitations:\n"
        '[#1] (doc=A, sent_id=0) "The sky is blue."\n'
        '[#2] (doc=B, sent_id=1) "Alice Smith was born in Paris."\n'
        "\nQuestion: Where was Alice Smith born?\nAnswer:"
    )
    out = mp.complete(prompt, purpose="synthesize")
    assert "[#2]" in out["text"]
    assert "Paris" in out["text"]


def test_mock_provider_factcheck_valid_json():
    mp = MockProvider()
    prompt = (
        "You are a strict but fair fact-checker.\nReturn pure JSON\n\n"
        "Question:\nWhere was Alice born?\n\nAnswer:\nAlice was born in Paris [#1]\n\n"
        'Citations:\n[#1] (doc=B, sent_id=1) "Alice Smith was born in Paris."\n'
    )
    out = mp.complete(prompt, purpose="factcheck")
    data = json.loads(out["text"])
    assert data["verdict"] == "supported"
    assert 1 in data["valid_citations"]


def test_span_and_artifacts(tmp_path):
    sink = LocalJsonlSink(root_dir=str(tmp_path))
    with span("NodeA", sink, "tr"):
        pass
    with span("NodeB", sink, "tr"):
        pass
    evts = [json.loads(l) for l in (tmp_path / "tr" / "events.jsonl").read_text().splitlines()]
    lb = build_latency_breakdown(evts)
    assert set(lb["by_node"]) == {"NodeA", "NodeB"}
    mmd = build_mermaid(evts)
    assert "NodeA --> NodeB" in mmd


def test_span_records_error(tmp_path):
    sink = LocalJsonlSink(root_dir=str(tmp_path))
    with pytest.raises(ValueError):
        with span("Bad", sink, "tr2"):
            raise ValueError("boom")
    evts = [json.loads(l) for l in (tmp_path / "tr2" / "events.jsonl").read_text().splitlines()]
    assert any(e["event"] == "error" for e in evts)


def test_synthetic_dataset_deterministic_and_solvable():
    loader = build_dataset_loader({"type": "synthetic_hotpotqa", "count": 4, "seed": 7})
    a = loader.load()
    b = SyntheticHotpotQALoader({"count": 4, "seed": 7}).load()
    assert [s["_id"] for s in a] == [s["_id"] for s in b]
    s = a[0]
    titles = [t for t, _ in s["context"]]
    assert len(s["supporting_facts"]) == 2
    for t, sid in s["supporting_facts"]:
        assert t in titles
    # the answer city appears in a supporting sentence
    joined = " ".join(" ".join(sents) for _, sents in s["context"])
    assert s["answer"] in joined


def test_build_providers_and_router_from_settings(settings):
    providers = build_providers(settings)
    assert "mock" in providers and "local_embed" in providers
    router = build_router(settings, providers)
    vecs = router.embed(texts=["the quick brown fox", "the quick brown fox jumps"])
    v = np.array(vecs)
    assert v.shape[1] == 64
    sim = float(v[0] @ v[1] / (np.linalg.norm(v[0]) * np.linalg.norm(v[1])))
    assert sim > 0.5  # lexical overlap -> high cosine


def test_verify_out_contract_fields():
    v = VerifyOut(status="pass", verdict="PASS", final_score=0.9, status_detail="high_conf_pass")
    d = v.model_dump()
    for key in ("status", "findings", "ok", "score", "issues", "diagnostics",
                "coverage_score", "consistency_score", "hallucination_risk",
                "final_score", "verdict", "self_consistency",
                "recommended_action", "status_detail", "status_detail_label"):
        assert key in d


def test_retrieval_in_defaults():
    r = RetrievalIn(query="q", trace_id="t")
    assert r.top_k == 20 and r.graph_id == "" and r.graph_window is None
