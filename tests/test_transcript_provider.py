"""Recorded-transcript LLM provider (VERDICT r3 item 8): replaying
realistic plan/draft/verdict VARIANCE through reasoning + verification.

The deterministic mock can only produce unanimity, so the self-consistency
aggregation paths (majority vote over drafts, verdict mixes over sc runs)
had never seen disagreement end-to-end. Here a hand-authored transcript
feeds: two plan phrasings (one with chatter before the numbered list),
three synthesize drafts where two agree and one dissents, and a 3/1/1
supported/insufficient/contradicted verdict mix over five fact-check runs.
"""
import json
from pathlib import Path

import pytest

REPO_ROOT = Path(__file__).resolve().parent.parent

from a_modular_rag_framework_tpu.cli.ingest_hotpotqa import ingest
from a_modular_rag_framework_tpu.core.dataset_loader import (
    SyntheticHotpotQALoader,
)
from a_modular_rag_framework_tpu.core.providers import (
    TranscriptRecorder,
    TranscriptReplayProvider,
)
from a_modular_rag_framework_tpu.system import answer_question, reset_system_cache

# ---------------- unit: replay mechanics ----------------


def _write(path: Path, entries) -> str:
    path.write_text("\n".join(json.dumps(e) for e in entries) + "\n")
    return str(path)


def test_replay_cycles_responses(tmp_path):
    p = _write(tmp_path / "t.jsonl", [
        {"purpose": "plan", "responses": ["A", "B"]},
    ])
    prov = TranscriptReplayProvider(p)
    texts = [prov.complete("anything", purpose="plan")["text"]
             for _ in range(5)]
    assert texts == ["A", "B", "A", "B", "A"]


def test_matching_precedence(tmp_path):
    p = _write(tmp_path / "t.jsonl", [
        {"purpose": "synthesize", "responses": ["catchall"]},
        {"purpose": "synthesize", "contains": "Marie", "responses": ["sub"]},
        {"purpose": "synthesize", "prompt": "exact prompt",
         "responses": ["exact"]},
    ])
    prov = TranscriptReplayProvider(p)
    assert prov.complete("exact prompt", purpose="synthesize")["text"] == "exact"
    assert prov.complete("about Marie Okafor", purpose="synthesize")["text"] == "sub"
    assert prov.complete("other", purpose="synthesize")["text"] == "catchall"


def test_unmatched_falls_back_to_mock_or_raises(tmp_path):
    p = _write(tmp_path / "t.jsonl", [
        {"purpose": "plan", "responses": ["A"]},
    ])
    prov = TranscriptReplayProvider(p)
    out = prov.complete("Question:\nWho is X?", purpose="factcheck")
    assert out["text"] and "replayed" not in out  # mock path
    strict = TranscriptReplayProvider(p, strict=True)
    with pytest.raises(KeyError):
        strict.complete("Question:\nWho is X?", purpose="factcheck")
    with pytest.raises(FileNotFoundError):
        TranscriptReplayProvider(str(tmp_path / "missing.jsonl"), strict=True)


def test_embed_delegates_to_mock(tmp_path):
    prov = TranscriptReplayProvider("")
    out = prov.embed(["a", "b"])
    assert len(out["vectors"]) == 2 and len(out["vectors"][0]) == 64


def test_recorder_roundtrip(tmp_path):
    from a_modular_rag_framework_tpu.core.providers import MockProvider

    out_path = tmp_path / "rec.jsonl"
    with TranscriptRecorder(MockProvider(), out_path=str(out_path)) as rec:
        r1 = rec.complete("Question:\nWho wrote X?", purpose="plan")
        r2 = rec.complete("Question:\nWho wrote X?", purpose="plan")
    replay = TranscriptReplayProvider(str(out_path), strict=True)
    assert replay.complete("Question:\nWho wrote X?",
                           purpose="plan")["text"] == r1["text"]
    assert replay.complete("Question:\nWho wrote X?",
                           purpose="plan")["text"] == r2["text"]


# ---------------- e2e: variance through the full pipeline ----------------


N_SAMPLES = 4


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("transcript_e2e")
    samples = SyntheticHotpotQALoader({"count": N_SAMPLES, "seed": 11}).load()
    docs_out = root / "data" / "docs.jsonl"
    ingest(samples, graph_root=root / "data" / "graph_ingest",
           docs_out=docs_out, build_graphs=True, pack=True)

    s = samples[0]
    gold = s["answer"]
    agree = f"{gold} [#1]"
    transcript = root / "transcript.jsonl"
    _write(transcript, [
        # plan variance: straight list, then one with prose chatter the
        # parser must drop (numbered lines exist -> unnumbered = chatter)
        {"purpose": "plan", "responses": [
            "1) Identify the collaborator the question pivots on\n"
            "2) Find the birthplace of that collaborator",
            "Sure! Here is the plan:\n"
            "Step 1: spot the pivot person\n"
            "Step 2 - look up where they were born",
        ]},
        # drafts that DISAGREE: two for gold (differing in punctuation
        # only -> same normalized vote), one dissenting
        {"purpose": "synthesize", "responses": [
            agree, "Atlantis [#2]", f"{gold}. [#1]",
        ]},
        # verdict mix over the 5 sc runs: 3 supported / 1 insufficient /
        # 1 contradicted -> majority supported at agreement 0.6
        {"purpose": "factcheck", "responses": [
            json.dumps({"verdict": "supported", "score": 0.9,
                        "valid_citations": [1]}),
            json.dumps({"verdict": "insufficient", "score": 0.4}),
            json.dumps({"verdict": "supported", "score": 0.85,
                        "valid_citations": [1]}),
            json.dumps({"verdict": "contradicted", "score": 0.2,
                        "misleading_citations": [2]}),
            json.dumps({"verdict": "supported", "score": 0.9}),
        ]},
    ])

    base = json.loads((REPO_ROOT / "config" / "settings.json").read_text())
    base["providers"]["transcript"] = {
        "type": ("a_modular_rag_framework_tpu.core.providers."
                 "transcript_provider:TranscriptReplayProvider"),
        "kwargs": {"transcript_path": str(transcript)},
    }
    route = [{"model": "recorded", "provider": "transcript",
              "ctx": 32000, "price": 0.0}]
    base["llm_policy"]["routes"]["ReasoningAgent"] = {
        "plan": route, "synthesize": route}
    base["llm_policy"]["routes"]["VerifierAgent"] = {"factcheck": route}
    rcfg = base["modules"]["retrieval"]["impl_kwargs"]
    rcfg["index_path"] = str(docs_out)
    rcfg["graph_root"] = str(root / "data" / "graph")
    base["modules"]["graph_construction"]["impl_kwargs"]["root_dir"] = \
        str(root / "data" / "graph")
    # three drafts so the vote actually aggregates; no refine round (it
    # would re-synthesize and overwrite the voted answer)
    base["modules"]["reasoning"]["impl_kwargs"]["n_drafts"] = 3
    base["modules"]["reasoning"]["impl_kwargs"]["max_refine_rounds"] = 0
    base["modules"]["verification"]["impl_kwargs"]["sc_runs"] = 5

    settings_path = root / "settings.json"
    settings_path.write_text(json.dumps(base))
    reset_system_cache()
    return {"settings": str(settings_path), "sample": s,
            "runs": str(root / "runs"), "gold": gold}


def test_disagreeing_drafts_resolve_by_majority(env):
    res = answer_question(env["sample"]["question"], mode="full",
                          settings_path=env["settings"],
                          runs_dir=env["runs"])
    answer = res["reasoning"]["answer"]
    assert env["gold"] in answer and "Atlantis" not in answer
    votes = res["reasoning"]["steps"][3]["votes"]
    assert len(votes) == 2, f"expected a 2-1 split, got {votes}"
    assert sorted(votes.values()) == [1, 2]


def test_verdict_mix_aggregates_below_unanimity(env):
    res = answer_question(env["sample"]["question"], mode="full",
                          settings_path=env["settings"],
                          runs_dir=env["runs"])
    sc = res["verification"]["self_consistency"]
    assert sc["runs"] == 5
    assert sc["majority_verdict"] == "supported"
    assert 0.0 < sc["agreement_rate"] < 1.0, (
        "mixed verdicts must surface as sub-unanimous agreement")
    # contradicted was a minority — the pipeline must not hard-fail on it
    assert res["verification"]["verdict"] not in ("FAIL-CONTRADICTED",)


def test_plan_variance_is_coerced_identically(env):
    # second call cycles to the chatter-prefixed plan; the step parser
    # must recover the same number of hops
    res = answer_question(env["sample"]["question"], mode="full",
                          settings_path=env["settings"],
                          runs_dir=env["runs"])
    plan = res["reasoning"]["steps"][0]["plan"]
    assert len(plan.splitlines()) == 2
    assert "Sure!" not in plan and "Here is the plan" not in plan
