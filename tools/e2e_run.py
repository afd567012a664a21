"""Recorded end-to-end QA runs (docs/E2E_RUN.{md,json}) — repeatable driver.

Runs the FULL workflow (graph construction -> hybrid retrieval w/ iterative
2-hop -> plan/synthesize reasoning -> rules+LLM verification + retry loop)
through `answer_question` under the shipped config/settings.json, over an
ingested synthetic corpus, and reports EM / relaxed EM / F1 / verdicts.
This is the recorded counterpart of the reference's run_system mode
(/root/reference/my_code/run_system.py:13-66).

  python tools/e2e_run.py [--corpus plain|variety] [--samples 300] \
      [--questions 100] [--tag plain_shipped]

Updates docs/E2E_RUN.json in place under --tag (other entries preserved).
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def build_corpus_settings(samples, work: Path, *, index_titles=False):
    """Ingest a sample corpus under ``work`` and write a settings.json that
    repoints the SHIPPED config at it (shared by e2e_run.py and
    e2e_failure_anatomy.py so both always measure the same configuration).
    Returns the settings path."""
    from a_modular_rag_framework_tpu.cli.ingest_hotpotqa import ingest

    docs_out = work / "docs.jsonl"
    ingest(samples, graph_root=work / "graph", docs_out=docs_out,
           index_titles=index_titles)
    settings = json.loads((ROOT / "config" / "settings.json").read_text())
    rk = settings["modules"]["retrieval"].setdefault("impl_kwargs", {})
    rk["index_path"] = str(docs_out)
    rk["graph_root"] = str(work / "graph")
    if index_titles:
        rk["index_titles"] = True
    s_path = work / "settings.json"
    s_path.write_text(json.dumps(settings))
    return s_path, settings


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", default="plain",
                    choices=["plain", "variety", "heldout", "natural"])
    ap.add_argument("--samples", type=int, default=300)
    ap.add_argument("--questions", type=int, default=100)
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--tag", default=None,
                    help="E2E_RUN.json key (default <corpus>_shipped)")
    ap.add_argument("--no_write", action="store_true")
    args = ap.parse_args()
    tag = args.tag or f"{args.corpus}_shipped"

    from a_modular_rag_framework_tpu.core.dataset_loader import (
        SyntheticHotpotQALoader,
    )
    from a_modular_rag_framework_tpu.eval.metrics import exact_match, f1_score
    from a_modular_rag_framework_tpu.system import answer_question

    if args.corpus == "natural":
        # hand-authored real-world corpus in the real HotpotQA schema
        # (tools/author_natural_corpus.py; VERDICT r3 item 8)
        nat = ROOT / "data" / "natural" / "natural_hotpotqa.json"
        samples = json.loads(nat.read_text())[: args.samples]
        ds_cfg = {"type": "hotpotqa", "path": str(nat),
                  "count": args.samples}
    else:
        ds_cfg = {
            "type": "synthetic_hotpotqa", "count": args.samples,
            "seed": args.seed, "unique_entities": True,
            "variety": args.corpus == "variety",
            "heldout": args.corpus == "heldout",
        }
        samples = SyntheticHotpotQALoader(ds_cfg).load()
    work = Path(tempfile.mkdtemp(prefix="e2e_run_"))
    s_path, settings = build_corpus_settings(
        samples, work, index_titles=args.corpus == "natural")
    settings["dataset"] = ds_cfg
    s_path.write_text(json.dumps(settings))

    ems, rems, f1s, verdicts = [], [], [], {}
    # verifier-vs-EM confusion (VERDICT r4 item 4): does the verdict
    # actually separate right answers from wrong ones?
    confusion = {"right_pass": 0, "right_fail": 0,
                 "wrong_pass": 0, "wrong_fail": 0}
    retry_rounds = {}
    retry_recovered = 0
    t0 = time.time()
    for s in samples[: args.questions]:
        res = answer_question(s["question"], mode="full",
                              settings_path=str(s_path))
        pred = (res.get("reasoning") or {}).get("answer") or ""
        gold = s["answer"]
        em = exact_match(pred, gold)
        ems.append(em)
        rems.append(1.0 if gold.lower() in pred.lower() else 0.0)
        f1s.append(f1_score(pred, gold))
        ver = res.get("verification") or {}
        v = ver.get("verdict") or "?"
        verdicts[v] = verdicts.get(v, 0) + 1
        ok = bool(ver.get("ok"))
        key = ("right" if em else "wrong") + ("_pass" if ok else "_fail")
        confusion[key] += 1
        rr = int(res.get("retry_round") or 0)
        retry_rounds[str(rr)] = retry_rounds.get(str(rr), 0) + 1
        if rr > 0 and em:
            retry_recovered += 1
    total = time.time() - t0

    n = max(len(ems), 1)
    wrong = confusion["wrong_pass"] + confusion["wrong_fail"]
    fails = confusion["wrong_fail"] + confusion["right_fail"]
    row = {
        "n": len(ems),
        "corpus": args.corpus,
        "sentences": sum(len(se) for s in samples for _, se in s["context"]),
        "em": round(sum(ems) / n, 4),
        "em_relaxed": round(sum(rems) / n, 4),
        "f1": round(sum(f1s) / n, 4),
        "verdicts": verdicts,
        "verifier_confusion": confusion,
        # of the WRONG answers, how many did the verifier flag?
        "verdict_recall_on_wrong": round(
            confusion["wrong_fail"] / wrong, 4) if wrong else None,
        # of the FLAGGED answers, how many were actually wrong?
        "verdict_precision_on_fail": round(
            confusion["wrong_fail"] / fails, 4) if fails else None,
        "retry_rounds": retry_rounds,
        "retry_recovered": retry_recovered,
        "total_sec": round(total, 1),
        "sec_per_question": round(total / n, 2),
    }
    print(json.dumps({tag: row}, indent=2))

    if not args.no_write:
        out = ROOT / "docs" / "E2E_RUN.json"
        data = json.loads(out.read_text()) if out.exists() else {}
        data[tag] = row
        out.write_text(json.dumps(data, indent=2) + "\n")


if __name__ == "__main__":
    main()
