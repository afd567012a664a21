"""End-to-end: ingest -> init_system -> answer_question over the synthetic
dataset, fully offline (mock LLM + on-device hash embeddings)."""
import json
from pathlib import Path

import pytest

REPO_ROOT = Path(__file__).resolve().parent.parent

from a_modular_rag_framework_tpu.cli.ingest_hotpotqa import ingest
from a_modular_rag_framework_tpu.core.dataset_loader import SyntheticHotpotQALoader
from a_modular_rag_framework_tpu.system import answer_question, init_system, reset_system_cache

N_SAMPLES = 6


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Ingested corpus + settings file wired to temp dirs."""
    root = tmp_path_factory.mktemp("e2e")
    samples = SyntheticHotpotQALoader({"count": N_SAMPLES, "seed": 11}).load()

    docs_out = root / "data" / "docs.jsonl"
    stats = ingest(samples, graph_root=root / "data" / "graph_ingest",
                   docs_out=docs_out, build_graphs=True, pack=True)
    assert stats["sentences"] > 0

    base = json.loads(Path("config/settings.json").read_text())
    base["dataset"] = {"type": "synthetic_hotpotqa", "count": N_SAMPLES, "seed": 11}
    rcfg = base["modules"]["retrieval"]["impl_kwargs"]
    rcfg["index_path"] = str(docs_out)
    rcfg["graph_root"] = str(root / "data" / "graph")
    gcfg = base["modules"]["graph_construction"]["impl_kwargs"]
    gcfg["root_dir"] = str(root / "data" / "graph")
    # keep the test fast: fewer self-consistency runs
    base["modules"]["verification"]["impl_kwargs"]["sc_runs"] = 2

    settings_path = root / "settings.json"
    settings_path.write_text(json.dumps(base))
    reset_system_cache()
    return {"root": root, "settings": str(settings_path), "samples": samples,
            "runs": str(root / "runs")}


def test_full_pipeline_answers_question(env):
    s = env["samples"][0]
    res = answer_question(s["question"], mode="full",
                          settings_path=env["settings"], runs_dir=env["runs"])

    # all stages produced output
    assert res["graph"]["node_count"] > 0 and res["graph"]["edge_count"] > 0
    assert res["retrieval"]["hits"], "retrieval returned no hits"
    assert res["reasoning"]["answer"]
    assert res["verification"]["verdict"] is not None
    assert res["metrics"]["t_end"] >= res["metrics"]["t1"]

    # the per-question graph was persisted in reference-compatible format
    graph_id = res["graph"]["graph_id"]
    gdir = Path(env["root"]) / "data" / "graph" / graph_id
    g = json.loads((gdir / "graph.json").read_text())
    assert g["node_count"] == res["graph"]["node_count"]

    # telemetry artifacts
    trace_dir = Path(env["runs"]) / res["trace_id"]
    events = trace_dir / "events.jsonl"
    assert events.exists()
    names = [json.loads(l).get("node") for l in events.read_text().splitlines()]
    for node in ("InitExternal", "Ingest", "BuildGraph", "ChooseRoute",
                 "Retrieval", "Reasoning", "Verify", "PackResult"):
        assert node in names, f"missing span for {node}"
    assert (trace_dir / "run.json").exists()
    assert (trace_dir / "assets" / "flow.mmd").exists()


def test_graph_only_mode_skips_retrieval(env):
    s = env["samples"][1]
    res = answer_question(s["question"], mode="graph_only",
                          settings_path=env["settings"], runs_dir=env["runs"])
    assert res["graph"]["node_count"] > 0
    assert not res.get("retrieval")
    assert not res.get("reasoning")


def test_retrieval_uses_qmatch_seeds_from_graph(env):
    s = env["samples"][2]
    res = answer_question(s["question"], mode="full",
                          settings_path=env["settings"], runs_dir=env["runs"])
    diag = res["retrieval"]["diagnostics"]
    assert diag["seed_mode"] in ("qmatch", "bm25_weighted")
    # the per-question graph exists, so qmatch seeds should have been found
    assert diag["seed_mode"] == "qmatch" and diag["seed_count"] > 0


def test_system_answers_gold_on_easy_sample(env):
    """With per-question context (distractor setting), the mock pipeline
    should answer at least some questions with the gold city."""
    from a_modular_rag_framework_tpu.eval.metrics import contains_match

    hits = 0
    for s in env["samples"][:4]:
        res = answer_question(s["question"], mode="full",
                              settings_path=env["settings"], runs_dir=env["runs"])
        hits += contains_match(res["reasoning"]["answer"], s["answer"])
    assert hits >= 1, "no question answered with the gold answer"


def test_init_system_cache(env):
    wf1, sink1 = init_system(env["settings"], runs_dir=env["runs"])
    wf2, sink2 = init_system(env["settings"], runs_dir=env["runs"])
    assert wf1 is wf2 and sink1 is sink2


def test_answer_question_without_ingested_corpus(tmp_path, monkeypatch):
    """Out-of-box drive: with NO ingested corpus the retrieval backend
    falls back to the per-question graph's sentence nodes and the system
    still answers correctly (the reference returned nothing here)."""
    monkeypatch.chdir(tmp_path)
    from a_modular_rag_framework_tpu.system import answer_question

    res = answer_question(
        "In which city was the collaborator of Sage Silverton born?",
        mode="full",
        settings_path=str(REPO_ROOT / "config" / "settings.json"),
    )
    answer = (res.get("reasoning") or {}).get("answer") or ""
    # the mock extracts the location span, so the answer is the city name
    # (plus citations), never the no-evidence fallback text
    assert answer and "No supporting evidence" not in answer
    from a_modular_rag_framework_tpu.core.dataset_loader import (
        SyntheticHotpotQALoader,
    )

    sample = next(
        s for s in SyntheticHotpotQALoader({"count": 8, "seed": 0}).load()
        if "Sage Silverton" in s["question"])
    assert sample["answer"] in answer
    diag = (res.get("retrieval") or {}).get("diagnostics") or {}
    assert diag.get("fallback") == "graph_sentences"
