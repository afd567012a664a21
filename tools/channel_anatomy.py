"""Per-channel placement anatomy for single-pass retrieval misses.

The round-3 diagnostic that exposed the fusion failure behind the 0.50
single-pass recall on colliding corpora: for every gold sentence missing
from the fused top-k, report whether it is present in each channel's own
top-200 (black-box: three single-channel engines) and at what rank. If
the misses are IN the pools at good ranks, fusion weights are the
problem, not pool coverage — that finding produced the two-stage fusion
(EngineConfig.order_alphas; docs/ROUND3.md).

  JAX_PLATFORMS=cpu python tools/channel_anatomy.py [--samples 600]
      [--entities collide|unique] [--seed 0] [--cache DIR]
"""
from __future__ import annotations

import argparse
import collections
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=600)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--entities", default="collide",
                    choices=["collide", "unique"])
    ap.add_argument("--cache", default=None,
                    help="load a PackedIndex instead of building")
    ap.add_argument("--questions", type=int, default=128)
    args = ap.parse_args()

    from a_modular_rag_framework_tpu.core.dataset_loader import (
        SyntheticHotpotQALoader,
    )
    from a_modular_rag_framework_tpu.engine.query_engine import (
        EngineConfig,
        QueryEngine,
    )
    from a_modular_rag_framework_tpu.eval.harness import gold_hit_ids
    from a_modular_rag_framework_tpu.index.builder import build_packed_index
    from a_modular_rag_framework_tpu.index.corpus import SentenceCorpus
    from a_modular_rag_framework_tpu.index.packed import PackedIndex

    samples = SyntheticHotpotQALoader(
        {"count": args.samples, "seed": args.seed, "n_distractors": 8,
         ("collide_entities" if args.entities == "collide"
          else "unique_entities"): True}).load()
    if args.cache:
        idx = PackedIndex.load(args.cache)
    else:
        idx = build_packed_index(SentenceCorpus.from_hotpotqa(samples),
                                 embed_dim=64, embed_dtype="bfloat16")

    Q = args.questions
    base = dict(pool_k=200, graph_window=2, bm25_posting_cap=1024,
                batch_buckets=(Q,), query_df_ratio_max=0.05,
                bm25_term_topm=16, graph_compact_cap=128,
                graph_wave_dtype="bfloat16")
    fused = QueryEngine(idx, config=EngineConfig(top_k=10, **base))
    chans = {}
    for name, al in (("text", (1, 0, 0)), ("graph", (0, 1, 0)),
                     ("dense", (0, 0, 1))):
        e = QueryEngine(idx, config=EngineConfig(
            top_k=200, alpha_text=al[0], alpha_graph=al[1],
            alpha_dense=al[2], **base))
        chans[name] = e

    qs = [s["question"] for s in samples[:Q]]
    ids = np.asarray(fused.query_batch(qs).hits.ids)
    chan_ids = {n: np.asarray(e.query_batch(qs).hits.ids)
                for n, e in chans.items()}

    hitid2row = {idx.corpus.hit_id(i): i for i in range(idx.n_docs)}
    stats = collections.Counter()
    ranks = {n: [] for n in chans}
    for row, s in enumerate(samples[:Q]):
        gold = [hitid2row.get(g) for g in gold_hit_ids(s)]
        got10 = set(int(i) for i in ids[row][:10])
        for j, g in enumerate(gold):
            tag = f"hop{j + 1}"
            if g is None:
                # gold sentence absent from the loaded index (cache/sample
                # mismatch): a setup problem, not a retrieval miss — keep
                # it out of the pool-coverage anatomy
                stats[f"{tag}_gold_not_in_corpus"] += 1
                continue
            if g in got10:
                stats[f"{tag}_hit"] += 1
                continue
            stats[f"{tag}_miss"] += 1
            for name, cid in chan_ids.items():
                lst = list(cid[row])
                r = lst.index(g) if g in lst else -1
                stats[f"{tag}_miss_{name}_{'in' if r >= 0 else 'out'}"] += 1
                if r >= 0:
                    ranks[name].append(r)
    print(dict(stats))
    for name, v in ranks.items():
        if v:
            print(f"{name}: miss-gold rank median {int(np.median(v))} "
                  f"mean {np.mean(v):.1f} (n={len(v)})")


if __name__ == "__main__":
    main()
