"""Pre-build the learned-embedding sidecars for the scale caches.

bench.attach_learned builds a missing sidecar in-run (900s budget per
cache) — correct but it spends the recorded bench's wall on re-embeds.
Running this once beforehand persists embeddings_learned.npy next to
each cache so the bench attaches instantly and every scale row reports
dense_encoder=subword_collide_* with real dense recall (VERDICT r4
item 2).

Run:  python tools/prebuild_sidecars.py
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import (  # noqa: E402
    CACHE_DIR_100K,
    N_SAMPLES_100K,
    attach_learned,
    build_or_load_index,
)


def main():
    from a_modular_rag_framework_tpu.utils.jax_setup import (
        enable_compilation_cache,
    )

    enable_compilation_cache()

    idx1, _, _ = build_or_load_index(N_SAMPLES_100K, CACHE_DIR_100K,
                                     collide=True)
    t0 = time.time()
    enc, label, err = attach_learned(idx1, CACHE_DIR_100K)
    print(f"100k sidecar: {label} err={err} ({time.time()-t0:.1f}s)",
          flush=True)

    cache = Path(__file__).resolve().parents[1] / "data" / "bench_cache_1m"
    if (cache / "manifest.json").exists():
        from a_modular_rag_framework_tpu.index.packed import PackedIndex

        idxl = PackedIndex.load(cache)
        t0 = time.time()
        enc, label, err = attach_learned(idxl, cache)
        print(f"1m sidecar: {label} err={err} ({time.time()-t0:.1f}s)",
              flush=True)

    cache5 = Path(__file__).resolve().parents[1] / "data" / "bench_cache_5m"
    if (cache5 / "manifest.json").exists():
        from a_modular_rag_framework_tpu.index.packed import PackedIndex

        idx5 = PackedIndex.load(cache5)
        t0 = time.time()
        enc, label, err = attach_learned(idx5, cache5)
        print(f"5m sidecar: {label} err={err} ({time.time()-t0:.1f}s)",
              flush=True)


if __name__ == "__main__":
    main()
