"""Rebuild every gitignored data/ artifact the bench and e2e tools ride on.

The bench caches (packed indexes at 13k/100k/1M/5.17M rows) and the trained
checkpoints (encoder/splade/cross-encoder) live under data/, which is
gitignored — a fresh checkout has none of them. Everything is deterministic
(seeded generators, seeded training), so this one command restores the full
artifact set:

  python tools/restore_artifacts.py            # everything missing
  python tools/restore_artifacts.py --skip-5m  # skip the ~10min 5.17M build
  python tools/restore_artifacts.py --skip-training

Runs entirely on the host CPU (hash-embed index builds are native C++;
the checkpoint trainings are small models) and never opens the card, so
it is safe to run next to a device-bound bench.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

os.environ["JAX_PLATFORMS"] = "cpu"

DATA = REPO / "data"

# (module, args, output) — the exact training runs behind the shipped
# checkpoints' recorded numbers (docs/E2E_RUN.md, docs/ROUND3.md)
TRAININGS = [
    ("a_modular_rag_framework_tpu.cli.train_encoder",
     ["--variety", "--subword_ngrams", "8", "--steps", "600"],
     DATA / "encoder.npz"),
    ("a_modular_rag_framework_tpu.cli.train_splade",
     ["--steps", "300", "--eval_samples", "128"],
     DATA / "splade.npz"),
    # variety templates (paraphrased predicates) are where learned
    # expansion earns score beyond the idf-prior init: selection picked
    # step 50 (val mrr 0.906 vs 0.622 at step 0); in-domain recall@10
    # 0.487 vs BM25 0.247 (docs/SPLADE_TRAIN.json)
    ("a_modular_rag_framework_tpu.cli.train_splade",
     ["--variety", "--steps", "150", "--eval_samples", "128",
      "--eval_every", "25"],
     DATA / "splade_variety.npz"),
    ("a_modular_rag_framework_tpu.cli.train_cross_encoder",
     ["--steps", "300"],
     DATA / "cross_encoder.npz"),
    # the scale rows' rerank stage scores the COLLIDING distribution
    # (shared name tokens across hundreds of distractors) — train the
    # reranker on it (bench.load_reranker prefers this checkpoint)
    ("a_modular_rag_framework_tpu.cli.train_cross_encoder",
     ["--collide", "--steps", "300"],
     DATA / "cross_encoder_collide.npz"),
]


def build_caches(skip_5m: bool) -> None:
    from bench import (
        CACHE_DIR,
        CACHE_DIR_100K,
        N_SAMPLES,
        N_SAMPLES_100K,
        build_or_load_index,
    )

    t0 = time.time()
    idx, _, tb = build_or_load_index(N_SAMPLES, CACHE_DIR)
    print(f"bench_cache: {idx.n_docs} docs (build {tb}, "
          f"wall {time.time()-t0:.1f}s)", flush=True)
    t0 = time.time()
    idx, _, tb = build_or_load_index(N_SAMPLES_100K, CACHE_DIR_100K,
                                     collide=True)
    print(f"bench_cache_100k: {idx.n_docs} docs (build {tb}, "
          f"wall {time.time()-t0:.1f}s)", flush=True)

    from a_modular_rag_framework_tpu.core.dataset_loader import (
        SyntheticHotpotQALoader,
    )
    from a_modular_rag_framework_tpu.index.builder import build_packed_index
    from a_modular_rag_framework_tpu.index.corpus import SentenceCorpus
    from a_modular_rag_framework_tpu.index.packed import PackedIndex

    scales = [(47000, DATA / "bench_cache_1m")]
    if not skip_5m:
        scales.append((235000, DATA / "bench_cache_5m"))
    for count, cache in scales:
        if (cache / "manifest.json").exists():
            try:
                PackedIndex.load(cache)
                print(f"{cache.name}: cache intact, skipping", flush=True)
                continue
            except Exception:
                pass
        t0 = time.time()
        samples = SyntheticHotpotQALoader(
            {"count": count, "seed": 0, "n_distractors": 8,
             "collide_entities": True}).load()
        corpus = SentenceCorpus.from_hotpotqa(samples)
        t1 = time.time()
        idx = build_packed_index(corpus, embed_dim=64,
                                 embed_dtype="bfloat16", out_dir=str(cache))
        print(f"{cache.name}: {idx.n_docs} docs (gen {t1-t0:.1f}s, "
              f"build {time.time()-t1:.1f}s)", flush=True)


def train_checkpoints() -> None:
    env = dict(os.environ)
    for mod, args, out in TRAININGS:
        if out.exists():
            print(f"{out.name}: exists, skipping", flush=True)
            continue
        t0 = time.time()
        cmd = [sys.executable, "-m", mod, *args, "--out", str(out)]
        print("+", " ".join(cmd[1:]), flush=True)
        subprocess.run(cmd, check=True, cwd=str(REPO), env=env)
        print(f"{out.name}: trained in {time.time()-t0:.1f}s", flush=True)


def restore_sidecars(skip_5m: bool) -> None:
    """Learned-embedding sidecars for the scale caches (VERDICT r4 item 1):
    train the collide-distribution subword encoder (tools/dense_lab.py),
    then re-embed every present cache into embeddings_learned.npy. These
    are device tools — run them WITHOUT the forced-CPU env (the trainings
    above are host-sized; a 5.17M-row re-embed is not)."""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    enc = DATA / "encoder_collide.npz"
    if not enc.exists():
        t0 = time.time()
        cmd = [sys.executable, "tools/dense_lab.py", "--steps", "1500",
               "--batch", "1024", "--out", str(enc)]
        print("+", " ".join(cmd[1:]), flush=True)
        subprocess.run(cmd, check=True, cwd=str(REPO), env=env)
        print(f"{enc.name}: trained in {time.time()-t0:.1f}s", flush=True)
    else:
        print(f"{enc.name}: exists, skipping", flush=True)
    caches = ["bench_cache", "bench_cache_100k", "bench_cache_1m"]
    if not skip_5m:
        caches.append("bench_cache_5m")
    for name in caches:
        cache = DATA / name
        if not (cache / "manifest.json").exists():
            continue
        if (cache / "embeddings_learned.npy").exists():
            print(f"{name}: sidecar exists, skipping", flush=True)
            continue
        t0 = time.time()
        cmd = [sys.executable, "tools/reembed_index.py",
               "--cache", str(cache), "--encoder", str(enc)]
        print("+", " ".join(cmd[1:]), flush=True)
        subprocess.run(cmd, check=True, cwd=str(REPO), env=env)
        print(f"{name}: re-embedded in {time.time()-t0:.1f}s", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-5m", action="store_true")
    ap.add_argument("--skip-caches", action="store_true")
    ap.add_argument("--skip-training", action="store_true")
    ap.add_argument("--skip-sidecars", action="store_true")
    args = ap.parse_args()
    if not args.skip_caches:
        build_caches(args.skip_5m)
    if not args.skip_training:
        train_checkpoints()
    if not args.skip_sidecars:
        restore_sidecars(args.skip_5m)
    print("restore_artifacts: done", flush=True)


if __name__ == "__main__":
    main()
