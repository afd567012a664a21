"""Million-plus-passage scale check (VERDICT r1 item 3: "ideally 1M").

Builds a ~1M-sentence synthetic corpus (47k samples), packs it, and runs
the hybrid engine. With graph_impl=auto the compact (N-independent) graph
channel kicks in, so no [B, N] buffer exists anywhere in the program and
B=2048 fits HBM even at 1M rows; --graph_impl dense restores the [B, N]
wave formulation (then keep --batch <= 256: ~1GB per [B, N] buffer).

  python tools/bench_1m.py [--batch 2048] [--samples 47000]
  # fullwiki-representative scale (~5.1M sentences, needs its own cache):
  python tools/bench_1m.py --samples 235000 --cache data/bench_cache_5m
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

DEFAULT_CACHE = Path(__file__).resolve().parents[1] / "data" / "bench_cache_1m"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=47000)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--pool_k", type=int, default=200)
    ap.add_argument("--graph_impl", default="auto",
                    choices=["auto", "dense", "compact"])
    ap.add_argument("--cap", type=int, default=256,
                    help="compact-mode propagation cap per hop")
    ap.add_argument("--cache", type=str, default=str(DEFAULT_CACHE))
    ap.add_argument("--entities", default="collide",
                    choices=["collide", "unique"],
                    help="collide = factored name pools (shared first/"
                         "surname tokens across samples, titles unique) so "
                         "distractors genuinely compete; unique = round-2 "
                         "legacy filler")
    args = ap.parse_args()
    CACHE = Path(args.cache)

    from a_modular_rag_framework_tpu.utils.jax_setup import enable_compilation_cache
    enable_compilation_cache()
    from a_modular_rag_framework_tpu.core.dataset_loader import SyntheticHotpotQALoader
    from a_modular_rag_framework_tpu.engine.query_engine import EngineConfig, QueryEngine
    from a_modular_rag_framework_tpu.eval.harness import evaluate_retrieval
    from a_modular_rag_framework_tpu.index.builder import build_packed_index
    from a_modular_rag_framework_tpu.index.corpus import SentenceCorpus
    from a_modular_rag_framework_tpu.index.packed import PackedIndex

    t0 = time.time()
    samples = SyntheticHotpotQALoader(
        {"count": args.samples, "seed": 0, "n_distractors": 8,
         ("collide_entities" if args.entities == "collide"
          else "unique_entities"): True}).load()
    gen_sec = time.time() - t0
    print(f"samples: {len(samples)} in {gen_sec:.0f}s", file=sys.stderr)

    t_build = None
    idx = None
    if (CACHE / "manifest.json").exists():
        try:
            idx = PackedIndex.load(CACHE)
        except Exception:
            idx = None
    if idx is None:
        corpus = SentenceCorpus.from_hotpotqa(samples)
        t0 = time.time()
        idx = build_packed_index(corpus, embed_dim=64,
                                 embed_dtype="bfloat16", out_dir=str(CACHE))
        t_build = time.time() - t0
    B = args.batch
    # same operating point as bench.py's scale rows
    engine = QueryEngine(idx, config=EngineConfig(
        top_k=10, pool_k=args.pool_k, graph_window=2, batch_buckets=(B,),
        query_df_ratio_max=0.05, graph_impl=args.graph_impl,
        graph_compact_cap=args.cap, bm25_posting_cap=1024,
        bm25_term_topm=32, graph_wave_dtype="bfloat16"))
    qs = [s["question"] for s in samples[:B]]

    t0 = time.time()
    engine.query_batch(qs)
    compile_sec = time.time() - t0
    best = float("inf")
    for _ in range(3):
        t0 = time.time()
        engine.query_batch(qs)
        best = min(best, time.time() - t0)
    t0 = time.time()
    depth = 4
    for _ in engine.query_batches_pipelined([qs] * depth):
        pass
    pipe = (time.time() - t0) / depth

    quality = evaluate_retrieval(engine, samples[:128], k=10, batch_size=B)
    print(json.dumps({
        "corpus_passages": idx.n_docs,
        "batch": B,
        "sequential_qps": round(B / best, 1),
        "pipelined_qps": round(B / pipe, 1),
        "recall_at_10": round(quality["recall_at_10"], 4),
        "mrr": round(quality["mrr"], 4),
        "compile_sec": round(compile_sec, 1),
        "index_build_sec": round(t_build, 1) if t_build else None,
        "index_build_passages_per_sec": (idx.manifest.get("build_stats")
                                         or {}).get("passages_per_sec"),
        "index_device_bytes": int(
            sum(np.asarray(v).nbytes for v in engine._bm25.values())
            + np.asarray(engine._emb).nbytes
            + np.asarray(engine._nbrs).nbytes),
    }))


if __name__ == "__main__":
    main()
