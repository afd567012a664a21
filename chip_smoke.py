"""Smoke run of the hybrid retrieval engine and its server on one GPU.

    python chip_smoke.py                 # one card, every phase
    python chip_smoke.py --four-cards    # the sharded engine on 4 cards

Drives the main path once, in one process, through the entry points a user
calls: index build and learned re-embed of the 1,034,000-row colliding
corpus (cached under data/bench_cache_1m, so a second run skips it), the
engine's single-pass and iterative 2-hop programs at the bench's scale
configuration, the `QueryServer` micro-batcher behind the `cli/serve.py`
HTTP front, a parity check against the plain host reference, the QA
workflow (`system.answer_question`), and the full-corpus dense top-k paths
at deployment shapes. Each phase prints one line with its wall time and
readings; any failure ends the run with a non-zero exit. The last line of
stdout is the JSON result, printed only when every phase passed.

There is no CPU fallback: the run needs JAX's GPU backend.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

N_SAMPLES_1M = 47000          # -> 1,034,000 rows (tools/bench_1m.py)
CACHE_1M = REPO / "data" / "bench_cache_1m"
N_SAMPLES_PARITY = 600        # -> 13,200 rows (bench.py N_SAMPLES)
TOP_K = 10
MIN_RECALL = 0.95
# engine vs host reference: the dense channel runs in float32 at HIGHEST
# (engine.query_engine.DENSE_PRECISION) and BM25 in float32, so fused
# scores agree with the float64 reference to float32 rounding
PARITY_TOL = 1e-5
# sharded vs one-card engine: the same float32 programs, partitioned; sums
# may run in another order
SHARDED_TOL = 1e-5


def log(phase: str, seconds: float, **readings) -> None:
    body = " ".join(f"{k}={v}" for k, v in readings.items())
    print(f"[{phase}] {seconds:.3f}s {body}", flush=True)


def _median_ms(fn, reps: int) -> float:
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


# ---------------- phases ----------------


def phase_device(n_cards: int):
    """Require the GPU backend; print the card, JAX and nvidia-smi."""
    import jax

    t0 = time.perf_counter()
    backend = jax.default_backend()
    if backend != "gpu":
        raise RuntimeError(f"JAX backend is {backend!r}; this run needs a GPU")
    devs = jax.devices()
    if len(devs) < n_cards:
        raise RuntimeError(f"need {n_cards} GPUs, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    for line in smi.splitlines():
        print(line, flush=True)
    from a_modular_rag_framework_tpu.native import binding

    log("device", time.perf_counter() - t0, kind=repr(devs[0].device_kind),
        jax=jax.__version__, visible=len(devs),
        native_text=binding.native_available())
    return devs[:n_cards]


def phase_build(n_samples: int, cache: Path, *, learned: bool = True):
    """Generate the colliding corpus, pack it (cached) and, with
    ``learned``, attach the learned d=128 embeddings re-embedded on the
    card (cached sidecar); else keep the packed hash-64 embeddings."""
    import bench

    t0 = time.perf_counter()
    cached = cache.exists()
    idx, samples, _ = bench.build_or_load_index(n_samples, cache,
                                                collide=True)
    t_pack = time.perf_counter() - t0
    enc, label = None, "hash64"
    if learned:
        enc, label, err = bench.attach_learned(idx, cache)
        if err:
            raise RuntimeError(f"learned embeddings: {err}")
    log("build", time.perf_counter() - t0, rows=idx.n_docs,
        pack_s=round(t_pack, 3), dense=label, cached=cached)
    return idx, samples, enc


def _device_bytes(tree) -> int:
    import jax

    return int(sum(x.nbytes for x in jax.tree.leaves(tree)
                   if hasattr(x, "nbytes")))


def _peak_bytes(device):
    """peak_bytes_in_use of ``device`` (what the program's arrays took)."""
    return (device.memory_stats() or {}).get("peak_bytes_in_use")


def _recall(engine, samples, ids) -> float:
    from a_modular_rag_framework_tpu.eval.harness import gold_hit_ids
    from a_modular_rag_framework_tpu.eval.metrics import recall_at_k

    hid = engine.index.corpus.hit_id
    rec = [recall_at_k([hid(int(i)) for i in ids[r] if i >= 0],
                       gold_hit_ids(s), TOP_K)
           for r, s in enumerate(samples)]
    return float(sum(rec) / len(rec))


def phase_retrieve(idx, samples, enc, *, batch: int, n_batches: int,
                   n_iterative: int):
    """Bench scale configuration: pipelined single-pass and iterative
    2-hop, with recall@10 against the gold supporting facts."""
    import jax
    import numpy as np

    import bench
    from a_modular_rag_framework_tpu.modules.retrieval.multihop import (
        iterative_retrieve,
    )

    t0 = time.perf_counter()
    engine = bench.make_scale_engine(idx, encoder=enc,
                                     batch_buckets=(batch,))
    qs = [s["question"] for s in samples[:batch]]
    qs = (qs * (batch // len(qs) + 1))[:batch]
    r = engine.query_batch(qs, top_k=TOP_K)
    compile_s = time.perf_counter() - t0
    ids = np.asarray(r.hits.ids)
    if ids.shape != (batch, TOP_K) or not np.isfinite(
            np.asarray(r.hits.scores)).all():
        raise RuntimeError(f"bad single-pass output {ids.shape}")
    rec1 = _recall(engine, samples[:batch], ids)

    t1 = time.perf_counter()
    n = 0
    for res in engine.query_batches_pipelined([qs] * n_batches,
                                              top_k=TOP_K):
        n += len(np.asarray(res.hits.ids))
    qps = n / (time.perf_counter() - t1)

    it_qs = qs[:n_iterative]
    t2 = time.perf_counter()
    iterative_retrieve(engine, it_qs, top_k=TOP_K)  # compiles hop 2
    it_compile = time.perf_counter() - t2
    t3 = time.perf_counter()
    it_ids, it_sc, _, diag = iterative_retrieve(engine, it_qs, top_k=TOP_K)
    it_s = time.perf_counter() - t3
    rec2 = _recall(engine, samples[:n_iterative], np.asarray(it_ids))
    peak = _peak_bytes(jax.devices()[0])
    index_bytes = _device_bytes([engine._emb, engine._nbrs, engine._bm25])
    log("retrieve", time.perf_counter() - t0, batch=batch,
        compile_s=round(compile_s + it_compile, 3),
        single_qps=round(qps, 1), single_recall_at_10=round(rec1, 4),
        iterative_n=len(it_qs), iterative_qps=round(len(it_qs) / it_s, 1),
        iterative_recall_at_10=round(rec2, 4),
        hop2_active=diag.get("hop2_active"), index_device_bytes=index_bytes,
        peak_bytes_in_use=peak)
    if rec1 < MIN_RECALL or rec2 < MIN_RECALL:
        raise RuntimeError(f"recall@10 below {MIN_RECALL}: single {rec1:.4f}"
                           f" iterative {rec2:.4f}")
    return engine, compile_s + it_compile


def _post(url, body, timeout=300):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 method="POST",
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        out = json.loads(r.read())
    return out, time.perf_counter() - t0


def _same_hits(got, want_ids, want_scores, tol=1e-5) -> bool:
    """Served hits (dicts or Hit objects) == a direct engine row."""
    pairs = [(i, s) for i, s in zip(want_ids, want_scores) if i is not None]
    if len(got) != len(pairs):
        return False
    for h, (i, s) in zip(got, pairs):
        hid = h["id"] if isinstance(h, dict) else h.id
        hs = h["score"] if isinstance(h, dict) else h.score
        if hid != i or abs(float(hs) - float(s)) > tol:
            return False
    return True


def _direct_rows(engine, result):
    import numpy as np

    hid = engine.index.corpus.hit_id
    ids, sc = np.asarray(result[0]), np.asarray(result[1])
    return [([hid(int(i)) if i >= 0 else None for i in ids[r]], sc[r])
            for r in range(len(ids))]


def phase_serve(cache: Path, samples, *, n_clients: int, per_client: int):
    """`cli/serve.py` in process: build_engine(--index), QueryServer and
    the HTTP front on an ephemeral port; answers checked against direct
    calls of the same engine."""
    from http.server import ThreadingHTTPServer

    from a_modular_rag_framework_tpu.cli.serve import (
        _App,
        _make_handler,
        build_engine,
    )
    from a_modular_rag_framework_tpu.engine.server import QueryServer
    from a_modular_rag_framework_tpu.modules.retrieval.multihop import (
        iterative_retrieve,
    )

    t0 = time.perf_counter()
    args = argparse.Namespace(index=str(cache), settings="", top_k=TOP_K,
                              max_batch=2048, max_wait_ms=2.0)
    engine, n_docs, _ = build_engine(args)
    qs = [s["question"] for s in samples[:n_clients * per_client]]
    batch_qs = [s["question"] for s in samples[:64]]
    it_qs = [s["question"] for s in samples[:16]]
    # direct answers first: they also compile the bucket shapes, so the
    # served latencies below are steady state
    direct_single = {}
    for q in qs:
        r = engine.query_batch([q], top_k=TOP_K)
        direct_single[q] = _direct_rows(engine, (r.hits.ids, r.hits.scores))[0]
    rb = engine.query_batch(batch_qs, top_k=TOP_K)
    direct_batch = _direct_rows(engine, (rb.hits.ids, rb.hits.scores))
    direct_it = _direct_rows(engine, iterative_retrieve(engine, it_qs,
                                                        top_k=TOP_K))
    setup_s = time.perf_counter() - t0

    with QueryServer(engine, max_batch=args.max_batch,
                     max_wait_ms=args.max_wait_ms) as qserver:
        httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                    _make_handler(_App(qserver, n_docs)))
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        try:
            base = f"http://127.0.0.1:{httpd.server_address[1]}"
            lat, bad, errors = [], [], []
            lock = threading.Lock()

            def client(j):
                try:
                    for q in qs[j * per_client:(j + 1) * per_client]:
                        out, dt = _post(base + "/query",
                                        {"query": q, "top_k": TOP_K})
                        ok = _same_hits(out["hits"], *direct_single[q])
                        with lock:
                            lat.append(dt)
                            if not ok:
                                bad.append(q)
                except Exception as e:  # reported below, fails the phase
                    with lock:
                        errors.append(repr(e))

            t1 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(j,))
                       for j in range(n_clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            if errors or any(t.is_alive() for t in threads):
                raise RuntimeError(f"/query clients failed: {errors[:3]}")
            query_s = time.perf_counter() - t1
            out, batch_dt = _post(base + "/query_batch",
                                  {"queries": batch_qs, "top_k": TOP_K})
            bad_batch = sum(not _same_hits(g, *w) for g, w in
                            zip(out["results"], direct_batch))
            if len(out["results"]) != len(batch_qs):
                bad_batch = len(batch_qs)
            futs = [qserver.submit(q, top_k=TOP_K, mode="iterative")
                    for q in it_qs]
            bad_it = sum(not _same_hits(list(f.result(timeout=600)), *w)
                         for f, w in zip(futs, direct_it))
        finally:
            httpd.shutdown()
            httpd.server_close()
    lat.sort()
    log("serve", time.perf_counter() - t0, rows=n_docs,
        setup_s=round(setup_s, 3), query_requests=len(lat),
        clients=n_clients, query_qps=round(len(lat) / query_s, 1),
        p50_ms=round(lat[len(lat) // 2] * 1e3, 3),
        p99_ms=round(lat[min(len(lat) - 1, int(0.99 * len(lat)))] * 1e3, 3),
        query_mismatch=len(bad), batch_n=len(batch_qs),
        batch_ms=round(batch_dt * 1e3, 3), batch_mismatch=bad_batch,
        iterative_n=len(it_qs), iterative_mismatch=bad_it)
    if bad or bad_batch or bad_it:
        raise RuntimeError("served answers differ from direct engine calls")
    return setup_s


def phase_parity(n_samples: int, n_questions: int):
    """13.2k-row corpus (hash-64 embeddings in float32): engine top-10 vs
    the plain host reference, ids equal except at score gaps below
    PARITY_TOL."""
    import numpy as np

    from a_modular_rag_framework_tpu.core.dataset_loader import (
        SyntheticHotpotQALoader,
    )
    from a_modular_rag_framework_tpu.engine.query_engine import (
        DENSE_PRECISION,
        EngineConfig,
        QueryEngine,
    )
    from a_modular_rag_framework_tpu.eval.host_reference import (
        HostReference,
        compare_topk,
    )
    from a_modular_rag_framework_tpu.index.builder import build_packed_index
    from a_modular_rag_framework_tpu.index.corpus import SentenceCorpus

    t0 = time.perf_counter()
    samples = SyntheticHotpotQALoader(
        {"count": n_samples, "seed": 0, "n_distractors": 8,
         "unique_entities": True}).load()
    # no phrase pseudo-tokens: the reference's BM25 has none
    idx = build_packed_index(SentenceCorpus.from_hotpotqa(samples),
                             embed_dim=64, embed_dtype="float32",
                             bm25_phrase_tokens=False)
    n = idx.n_docs
    longest = int(np.diff(np.asarray(idx.bm25.row_ptr)).max())
    # exact settings: the phase-1 window covers every posting list and the
    # pool spans the corpus, so no BM25 tie sits at a pool boundary
    engine = QueryEngine(idx, config=EngineConfig(
        top_k=TOP_K, pool_k=n, graph_window=0, alpha_graph=0.0,
        batch_buckets=(n_questions,), bm25_term_topm=longest,
        bm25_posting_cap=longest, graph_pool_exact=True))
    qs = [s["question"] for s in samples[:n_questions]]
    r = engine.query_batch(qs, top_k=TOP_K)
    ids, sc = np.asarray(r.hits.ids), np.asarray(r.hits.scores)
    ref = HostReference(idx.corpus.texts(), embed_dim=64)
    fails = []
    for row, q in enumerate(qs):
        ok, why = compare_topk(ids[row], sc[row],
                               ref.fused(q, alphas=(0.4, 0.0, 0.4),
                                         pool_k=n), TOP_K, PARITY_TOL)
        if not ok:
            fails.append(f"q{row}: {why}")
    log("parity", time.perf_counter() - t0, rows=n, questions=len(qs),
        precision=DENSE_PRECISION.name, tol=PARITY_TOL,
        mismatched=len(fails))
    if fails:
        raise RuntimeError("engine != host reference: " + "; ".join(fails[:3]))


def phase_qa(n_questions: int, work: Path):
    """`system.answer_question` in full mode with the shipped settings
    (mock LLM, local embeddings); no embed call may fall back to mock."""
    import shutil

    from a_modular_rag_framework_tpu.core.dataset_loader import (
        SyntheticHotpotQALoader,
    )
    from a_modular_rag_framework_tpu.core.providers import local_embed_provider
    from a_modular_rag_framework_tpu.di.factory import (
        build_providers,
        build_router,
        load_settings,
    )
    from a_modular_rag_framework_tpu.system import answer_question

    t0 = time.perf_counter()
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    settings = load_settings(str(REPO / "config" / "settings.json"))
    # paths only: the run's files go under `work`
    rk = settings["modules"]["retrieval"]["impl_kwargs"]
    rk["index_path"] = str(work / "hotpotqa" / "docs.jsonl")
    rk["graph_root"] = str(work / "graph")
    settings["modules"]["graph_construction"]["impl_kwargs"]["root_dir"] = \
        str(work / "graph")
    settings["metrics"]["output"] = str(work / "metrics.json")
    s_path = work / "settings.json"
    s_path.write_text(json.dumps(settings))

    calls, fallbacks = [0], []
    provider_cls = local_embed_provider.LocalEmbedProvider
    real_embed = provider_cls.embed

    def counted(self, texts, **kw):
        calls[0] += 1
        return real_embed(self, texts, **kw)

    class _Fallback(logging.Handler):
        def emit(self, record):
            if "embed error" in record.getMessage():
                fallbacks.append(record.getMessage())

    handler = _Fallback(level=logging.ERROR)
    router_log = logging.getLogger("a_modular_rag_framework_tpu.core.llm_router")
    router_log.addHandler(handler)
    provider_cls.embed = counted
    answers = []
    try:
        samples = SyntheticHotpotQALoader({"count": 8, "seed": 0}).load()
        for s in samples[:n_questions]:
            res = answer_question(s["question"], mode="full",
                                  settings_path=str(s_path),
                                  runs_dir=str(work / "runs"))
            answer = (res.get("reasoning") or {}).get("answer") or ""
            verdict = (res.get("verification") or {}).get("verdict")
            if not answer.strip() or verdict is None:
                raise RuntimeError(f"no answer/verdict for {s['question']!r}")
            answers.append((answer, verdict, s["answer"] in answer))
        # the workflow embeds through the engine's encoder and the graph
        # builder; the router's embedding route is checked directly too
        router = build_router(settings, build_providers(settings))
        vecs = router.embed(texts=[s["question"] for s in samples[:5]])
        if len(vecs) != 5 or not all(len(v) == 64 for v in vecs):
            raise RuntimeError("router embeddings have the wrong shape")
    finally:
        provider_cls.embed = real_embed
        router_log.removeHandler(handler)
    log("qa", time.perf_counter() - t0, questions=len(answers),
        gold_in_answer=sum(a[2] for a in answers),
        verdicts=",".join(sorted({a[1] for a in answers})),
        embed_calls=calls[0], embed_fallbacks=len(fallbacks))
    if fallbacks or not calls[0]:
        raise RuntimeError(f"embeddings fell back to mock: {fallbacks[:2]} "
                           f"(provider calls: {calls[0]})")


def phase_dense_topk(engine, samples, *, B: int, N: int, d: int, k: int,
                     reps: int):
    """The exact XLA dense top-k paths at the removed kernel's shapes (bf16
    corpus, f32 accumulation), and query_dense_batch at the 1M index."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from a_modular_rag_framework_tpu.ops import topk

    t0 = time.perf_counter()
    key_q, key_d = jax.random.split(jax.random.PRNGKey(0))
    Q = jax.random.normal(key_q, (B, d), jnp.float32)
    D = jax.random.normal(key_d, (N, d), jnp.float32).astype(jnp.bfloat16)
    paths = {"xla": lambda: topk.dense_topk_xla(Q, D, k)}
    for t in (64, 128):
        paths[f"tiled{t}"] = (lambda t=t:
                              topk.dense_topk_exact_tiled(Q, D, k, n_tiles=t))
    ref_s, ref_i = jax.block_until_ready(paths["xla"]())
    times = {}
    for name, fn in paths.items():
        s, i = jax.block_until_ready(fn())  # compile + check
        if not (np.array_equal(np.sort(np.asarray(i), 1),
                               np.sort(np.asarray(ref_i), 1))
                and np.allclose(np.asarray(s), np.asarray(ref_s),
                                atol=1e-3)):
            raise RuntimeError(f"dense top-k path {name} != dense_topk_xla")
        times[name] = _median_ms(lambda: jax.block_until_ready(fn()), reps)
    flops = 2.0 * B * N * d
    # least bytes an unfused path moves: corpus once, scores out and back
    hbm = N * d * 2 + 2 * B * N * 4

    qs = [s["question"] for s in samples[:4096]]
    engine.query_dense_batch(qs, top_k=TOP_K)  # compile
    qd_ms = _median_ms(lambda: engine.query_dense_batch(qs, top_k=TOP_K),
                       reps)
    readings = {f"{n}_ms": round(v, 3) for n, v in times.items()}
    log("dense_topk", time.perf_counter() - t0, shape=f"B{B}xN{N}xd{d}k{k}",
        **readings,
        xla_tflops=round(flops / times["xla"] / 1e9, 2),
        xla_min_bytes_gb_s=round(hbm / times["xla"] / 1e6, 1),
        chosen="dense_topk_xla",
        query_dense_batch_ms=round(qd_ms, 3),
        query_dense_rows=engine.index.n_docs, query_dense_B=len(qs))


# ---------------- four cards ----------------


def _compare(a, b, tol):
    """Rows of (ids, scores[, norms]) from two engines agree: rank by rank,
    scores within tol, and an id differs only where its score ties (within
    tol) another hit of the row or the row's last score (a tie group cut by
    the top-k boundary), or, given each hit's channel norms ([B, 3, K]),
    where the two hits at that rank have the same norms in every channel:
    docs the engines cannot tell apart, whichever weighting selected the
    top-k. -> number of rows that disagree."""
    import numpy as np

    norms_a = a[2] if len(a) > 2 else [None] * len(a[0])
    norms_b = b[2] if len(b) > 2 else [None] * len(b[0])
    bad = 0
    for ia, sa, na, ib, sb, nb in zip(a[0], a[1], norms_a,
                                      b[0], b[1], norms_b):
        ia, ib = list(ia), list(ib)
        sa, sb = np.asarray(sa, np.float64), np.asarray(sb, np.float64)
        if len(ia) != len(ib) or not np.allclose(sa, sb, atol=tol):
            bad += 1
            continue
        for j in (j for j in range(len(ia)) if ia[j] != ib[j]):
            tied = np.abs(sa - sa[j]) <= tol
            tied[j] = False
            same_norms = na is not None and np.allclose(
                np.asarray(na, np.float64)[:, j],
                np.asarray(nb, np.float64)[:, j], atol=tol)
            if not (tied.any() or abs(sa[j] - sa[-1]) <= tol or same_norms):
                bad += 1
                break
    return bad


def _rows(result):
    """(ids, scores, norms [B, 3, K]) of an engine's QueryResult."""
    import numpy as np

    return (result.hits.ids, result.hits.scores,
            np.moveaxis(np.asarray(result.channel_norms), 0, 1))


def _max_diff(a, b) -> float:
    import numpy as np

    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def phase_four_cards(idx, samples, devices, *, batch: int):
    """ShardedHybridEngine over a 4-card data mesh vs the one-card engine:
    single-pass, iterative 2-hop, QueryServer, and the settings path.

    Both engines embed queries with the hash encoder, whose f32 features
    give both the same query vectors: the one-card engine computes them
    inside its program and the sharded engine in one of its own, and a
    bf16 encoder compiled into two programs may round its intermediates at
    different points, which min-max fusion then amplifies. That is the
    encoder's difference, not the sharding's, so it is left out."""
    import jax
    import numpy as np

    import bench
    from a_modular_rag_framework_tpu.di.factory import load_settings
    from a_modular_rag_framework_tpu.engine.query_engine import (
        QueryEngine,
    )
    from a_modular_rag_framework_tpu.engine.server import QueryServer
    from a_modular_rag_framework_tpu.modules.retrieval.flow import (
        RetrievalAgentFlow,
    )
    from a_modular_rag_framework_tpu.modules.retrieval.multihop import (
        iterative_retrieve,
    )
    from a_modular_rag_framework_tpu.parallel.mesh import build_mesh
    from a_modular_rag_framework_tpu.parallel.sharded_hybrid import (
        ShardedHybridEngine,
    )

    t0 = time.perf_counter()
    n = idx.n_docs
    # the bench's scale configuration as it ships (phase-1 window 16
    # postings per term, query terms with df above 5% pruned)
    one = bench.make_scale_engine(idx, batch_buckets=(batch,))
    mesh = build_mesh({"data": 4}, devices=devices)
    sharded = ShardedHybridEngine(idx, mesh=mesh, config=one.config)
    per_dev = {}
    for a in sharded._arr.values():
        for sh in a.addressable_shards:
            per_dev[sh.device.id] = per_dev.get(sh.device.id, 0) + \
                sh.data.nbytes
    total = sum(per_dev.values())
    spread = [round(v / total, 4) for _, v in sorted(per_dev.items())]
    if len(per_dev) != 4 or max(abs(f - 0.25) for f in spread) > 0.02:
        raise RuntimeError(f"row-sharded bytes not spread: {spread}")
    setup_s = time.perf_counter() - t0

    qs = [s["question"] for s in samples[:batch]]
    r_one = one.query_batch(qs, top_k=TOP_K)
    r_sh = sharded.query_batch(qs, top_k=TOP_K)
    bad_single = _compare(_rows(r_one), _rows(r_sh), SHARDED_TOL)
    single_diff = _max_diff(r_one.hits.scores, r_sh.hits.scores)
    rec_one = _recall(one, samples[:batch], np.asarray(r_one.hits.ids))
    rec_sh = _recall(sharded, samples[:batch], np.asarray(r_sh.hits.ids))
    it_qs = qs[:512]
    a = iterative_retrieve(one, it_qs, top_k=TOP_K)
    b = iterative_retrieve(sharded, it_qs, top_k=TOP_K)
    bad_it = _compare(a[:3], b[:3], SHARDED_TOL)
    if b[3].get("hop2_active", 0) == 0:
        raise RuntimeError("no hop-2 dispatch fired on the sharded engine")
    t1 = time.perf_counter()
    for _ in sharded.query_batches_pipelined([qs] * 4, top_k=TOP_K):
        pass
    sharded_qps = 4 * len(qs) / (time.perf_counter() - t1)

    served_qs = qs[:256]
    with QueryServer(sharded, max_batch=batch) as srv:
        futs = [srv.submit(q, top_k=TOP_K) for q in served_qs]
        got = [list(f.result(timeout=600)) for f in futs]
        it_futs = [srv.submit(q, top_k=TOP_K, mode="iterative")
                   for q in it_qs[:64]]
        got_it = [list(f.result(timeout=600)) for f in it_futs]
    want = one.query_batch(served_qs, top_k=TOP_K)
    hid = idx.corpus.hit_id

    def rows(ids, scores, norms):
        """Direct rows as the server hydrates them: padding dropped."""
        ids = np.asarray(ids)
        keep = [r >= 0 for r in ids]
        return ([[hid(int(i)) for i in r[m]] for r, m in zip(ids, keep)],
                [np.asarray(s)[m] for s, m in zip(scores, keep)],
                [np.asarray(n)[:, m] for n, m in zip(norms, keep)])

    def served(hits_rows):
        channels = ("text", "graph", "dense")
        return ([[h.id for h in r] for r in hits_rows],
                [[h.score for h in r] for r in hits_rows],
                [[[h.meta[f"score_{c}_norm"] for h in r] for c in channels]
                 for r in hits_rows])

    bad_served = _compare(served(got), rows(*_rows(want)), SHARDED_TOL)
    bad_served += _compare(served(got_it),
                           rows(a[0][:64], a[1][:64], a[2][:64]), SHARDED_TOL)

    # the shipped settings; only the batch bucket is set, to the batch sent
    settings = load_settings(str(REPO / "config" / "settings.json"))
    settings["kernels"]["query_batch_buckets"] = [batch]
    settings["modules"]["retrieval"]["impl_kwargs"].update(
        index=idx, default_top_k=TOP_K)
    flow = RetrievalAgentFlow.from_settings(settings)
    eng = flow.backend.engine
    if not isinstance(eng, ShardedHybridEngine) or eng.n_shards != 4:
        raise RuntimeError(f"settings path built {type(eng).__name__}, "
                           "not a 4-shard ShardedHybridEngine")
    one_s = QueryEngine(idx, config=eng.config)
    bad_settings = _compare(_rows(one_s.query_batch(qs, top_k=TOP_K)),
                            _rows(eng.query_batch(qs, top_k=TOP_K)),
                            SHARDED_TOL)
    bad_settings += _compare(iterative_retrieve(one_s, it_qs, top_k=TOP_K)[:3],
                             iterative_retrieve(eng, it_qs, top_k=TOP_K)[:3],
                             SHARDED_TOL)
    log("four_cards", time.perf_counter() - t0, rows=n, shards=4,
        setup_s=round(setup_s, 3), bytes_share=spread,
        single_mismatch=bad_single, single_max_score_diff=single_diff,
        recall_one_card=round(rec_one, 4), recall_sharded=round(rec_sh, 4),
        iterative_mismatch=bad_it,
        served_mismatch=bad_served, settings_mismatch=bad_settings,
        hop2_active=b[3].get("hop2_active"),
        sharded_qps=round(sharded_qps, 1), tol=SHARDED_TOL,
        peak_bytes_dev0=_peak_bytes(jax.devices()[0]))
    if bad_single or bad_it or bad_served or bad_settings:
        raise RuntimeError("sharded engine != one-card engine")


# ---------------- main ----------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded engine on 4 cards")
    args = ap.parse_args(argv)
    n_cards = 4 if args.four_cards else 1
    if n_cards == 1:
        # one card even where more are visible: JAX reserves memory on
        # every device it sees
        os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")

    from a_modular_rag_framework_tpu.utils.jax_setup import (
        enable_compilation_cache,
    )

    enable_compilation_cache()
    t_start = time.perf_counter()
    devices = phase_device(n_cards)
    t0 = time.perf_counter()
    idx, samples, enc = phase_build(N_SAMPLES_1M, CACHE_1M,
                                    learned=not args.four_cards)
    setup_s = time.perf_counter() - t0
    if args.four_cards:
        phase_four_cards(idx, samples, devices, batch=2048)
    else:
        engine, compile_s = phase_retrieve(idx, samples, enc, batch=4096,
                                           n_batches=4, n_iterative=512)
        setup_s += compile_s
        setup_s += phase_serve(CACHE_1M, samples, n_clients=8, per_client=4)
        phase_parity(N_SAMPLES_PARITY, 64)
        phase_qa(5, REPO / "data" / "smoke_qa")
        phase_dense_topk(engine, samples, B=1024, N=131072, d=512, k=100,
                         reps=5)
    total = time.perf_counter() - t_start
    log("total", total, setup_s=round(setup_s, 3),
        serving_s=round(total - setup_s, 3))
    import jax

    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
