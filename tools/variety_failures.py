"""Failure-mode analysis on the hard (variety) corpus.

The variety generator (core/dataset_loader.py `_make_sample_variety`) makes
2-hop bridge questions whose gold set is exactly two sentences:
  hop 1  "A collaborated with B"   (bridge — shares tokens with the question)
  hop 2  "B was born in CITY"      (birth — shares NO tokens with the question;
                                    only the graph/iterative channel reaches it)
plus twin distractors (question person's first name, answer city reused).

This tool buckets every recall@k miss by WHICH gold sentence was missed, for
both the single-shot hybrid and the iterative 2-hop retriever, so quality
work targets the real bottleneck instead of a guess.

  python tools/variety_failures.py [--samples 1000] [--questions 200] [--cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=1000)
    ap.add_argument("--questions", type=int, default=200)
    ap.add_argument("--seed", type=int, default=31)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    from a_modular_rag_framework_tpu.core.dataset_loader import (
        SyntheticHotpotQALoader,
    )
    from a_modular_rag_framework_tpu.engine.query_engine import (
        EngineConfig, QueryEngine,
    )
    from a_modular_rag_framework_tpu.index.builder import build_packed_index
    from a_modular_rag_framework_tpu.index.corpus import SentenceCorpus
    from a_modular_rag_framework_tpu.modules.retrieval.multihop import (
        iterative_retrieve,
    )

    samples = SyntheticHotpotQALoader({
        "count": args.samples, "seed": args.seed,
        "unique_entities": True, "variety": True,
    }).load()
    corpus = SentenceCorpus.from_hotpotqa(samples)
    idx = build_packed_index(corpus, embed_dim=64, embed_dtype="bfloat16")
    print(f"corpus: {len(corpus)} sentences from {args.samples} samples")

    engine = QueryEngine(idx, config=EngineConfig(
        top_k=args.k, pool_k=200, graph_window=2, bm25_posting_cap=1024,
        batch_buckets=(64,), query_df_ratio_max=0.05, bm25_term_topm=32))

    row_by = corpus.row_by_title_sid()
    qs = samples[:args.questions]

    def gold_rows(s):
        """{row: 'bridge'|'birth'} — bridge doc is the question person's."""
        out = {}
        qperson_doc = s["supporting_facts"][0][0]
        for title, sid in s["supporting_facts"]:
            r = row_by.get((title, sid))
            if r is not None:
                out[r] = "bridge" if title == qperson_doc else "birth"
        return out

    def bucket(run_ids):
        c = Counter()
        per_hop_hit = Counter()
        per_hop_n = Counter()
        for s, ids in zip(qs, run_ids):
            gold = gold_rows(s)
            got = set(int(i) for i in ids if i >= 0)
            missed = sorted({kind for r, kind in gold.items()
                             if r not in got})
            for r, kind in gold.items():
                per_hop_n[kind] += 1
                if r in got:
                    per_hop_hit[kind] += 1
            c["+".join(missed) if missed else "none"] += 1
        rec = {k: round(per_hop_hit[k] / per_hop_n[k], 3) for k in per_hop_n}
        return dict(c), rec

    # single-shot hybrid
    res = engine.query_batch([s["question"] for s in qs], top_k=args.k)
    ids = np.asarray(res.hits.ids)
    miss1, rec1 = bucket(list(ids))
    overall1 = np.mean([
        len([r for r in gold_rows(s) if r in set(map(int, row))]) /
        max(len(gold_rows(s)), 1)
        for s, row in zip(qs, ids)])

    # iterative 2-hop (batched; returns (ids, scores, norms, diagnostics))
    it_ids, _, _, _ = iterative_retrieve(
        engine, [s["question"] for s in qs], top_k=args.k)
    it_ids = list(np.asarray(it_ids))
    miss2, rec2 = bucket(it_ids)
    overall2 = np.mean([
        len([r for r in gold_rows(s) if r in set(map(int, row))]) /
        max(len(gold_rows(s)), 1)
        for s, row in zip(qs, it_ids)])

    print(json.dumps({
        "k": args.k,
        "single_shot": {"recall": round(float(overall1), 3),
                        "per_hop_recall": rec1, "miss_buckets": miss1},
        "iterative": {"recall": round(float(overall2), 3),
                      "per_hop_recall": rec2, "miss_buckets": miss2},
    }, indent=2))


if __name__ == "__main__":
    main()
