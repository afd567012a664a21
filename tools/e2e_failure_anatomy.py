"""Answer-level failure anatomy for the full workflow on the hard corpus.

The retrieval-level anatomy (tools/variety_failures.py) showed iterative
retrieval recovers 0.93 of gold sentences, yet end-to-end EM on the variety
corpus is ~0.44 — so where do the other answers go? For every miss this
buckets the cause:

  retrieval   — a gold sentence never reached the top-k hits
  evidence    — gold retrieved, but the cited evidence misses the birth fact
  extraction  — birth fact cited, but the answer span wasn't extracted

  python tools/e2e_failure_anatomy.py [--questions 100]
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=300)
    ap.add_argument("--questions", type=int, default=100)
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--corpus", default="variety")
    args = ap.parse_args()


    from a_modular_rag_framework_tpu.core.dataset_loader import (
        SyntheticHotpotQALoader,
    )
    from a_modular_rag_framework_tpu.eval.metrics import exact_match
    from a_modular_rag_framework_tpu.system import answer_question
    from e2e_run import build_corpus_settings

    if args.corpus == "natural":
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
    work = Path(tempfile.mkdtemp(prefix="e2e_anatomy_"))
    s_path, settings = build_corpus_settings(
        samples, work, index_titles=args.corpus == "natural")
    settings["dataset"] = ds_cfg
    s_path.write_text(json.dumps(settings))

    buckets = Counter()
    examples = {}
    n_hit = 0
    for s in samples[: args.questions]:
        res = answer_question(s["question"], mode="full",
                              settings_path=str(s_path))
        pred = (res.get("reasoning") or {}).get("answer") or ""
        gold = s["answer"]
        if exact_match(pred, gold):
            n_hit += 1
            continue
        hits = (res.get("retrieval") or {}).get("hits", [])
        hit_ids = {h.get("id") for h in hits}
        gold_ids = {f"sent::{t}::{sid}" for t, sid in s["supporting_facts"]}
        # the birth sentence = the supporting fact in the NON-question
        # person's doc (the answer city appears only there)
        birth_title = s["supporting_facts"][1][0]
        birth_id = f"sent::{birth_title}::{s['supporting_facts'][1][1]}"
        ev_used = (res.get("reasoning") or {}).get("evidence_used", [])
        ev_ids = {e.get("id") if isinstance(e, dict) else e for e in ev_used}

        if not (gold_ids <= hit_ids):
            kind = ("retrieval_birth_missing" if birth_id not in hit_ids
                    else "retrieval_bridge_missing")
        elif birth_id not in ev_ids:
            kind = "evidence_selection"
        else:
            kind = "extraction"
        buckets[kind] += 1
        examples.setdefault(kind, [])
        if len(examples[kind]) < 6:
            examples[kind].append({"q": s["question"], "gold": gold,
                                   "pred": pred[:90]})
    print(json.dumps({
        "questions": args.questions,
        "em_hits": n_hit,
        "miss_buckets": dict(buckets),
        "examples": examples,
    }, indent=2))


if __name__ == "__main__":
    main()
