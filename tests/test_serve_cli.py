"""HTTP serving front (cli/serve.py): routes, batching, error paths."""
import json
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import pytest

from a_modular_rag_framework_tpu.cli.serve import _App, _make_handler, build_engine
from a_modular_rag_framework_tpu.core.dataset_loader import SyntheticHotpotQALoader
from a_modular_rag_framework_tpu.engine.query_engine import EngineConfig, QueryEngine
from a_modular_rag_framework_tpu.engine.server import QueryServer
from a_modular_rag_framework_tpu.index.builder import build_packed_index
from a_modular_rag_framework_tpu.index.corpus import SentenceCorpus


@pytest.fixture(scope="module")
def http_app():
    samples = SyntheticHotpotQALoader({"count": 12, "seed": 5}).load()
    corpus = SentenceCorpus.from_hotpotqa(samples)
    idx = build_packed_index(corpus, embed_dim=32, embed_dtype="float32")
    eng = QueryEngine(idx, config=EngineConfig(top_k=5, pool_k=50,
                                                  batch_buckets=(8, 32)))
    with QueryServer(eng, max_batch=16, max_wait_ms=5.0) as qserver:
        app = _App(qserver, idx.n_docs, qa=False)
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(app))
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        try:
            yield f"http://127.0.0.1:{httpd.server_address[1]}", samples
        finally:
            httpd.shutdown()


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, json.loads(r.read())


def _post(url, body):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_healthz(http_app):
    base, _ = http_app
    code, out = _get(base + "/healthz")
    assert code == 200 and out["ok"] and out["corpus"] > 0


def test_query_roundtrip(http_app):
    base, samples = http_app
    code, out = _post(base + "/query",
                      {"query": samples[0]["question"], "top_k": 3})
    assert code == 200
    assert out["hits"] and len(out["hits"]) <= 3
    assert out["hits"][0]["id"].startswith("sent::")
    assert isinstance(out["hits"][0]["score"], float)


def test_query_batch_matches_singles(http_app):
    base, samples = http_app
    qs = [s["question"] for s in samples[:4]]
    _, batch = _post(base + "/query_batch", {"queries": qs})
    singles = [_post(base + "/query", {"query": q})[1]["hits"] for q in qs]
    assert len(batch["results"]) == 4
    for got, want in zip(batch["results"], singles):
        assert [h["id"] for h in got] == [h["id"] for h in want]


def test_concurrent_http_clients_microbatch(http_app):
    base, samples = http_app
    outs = [None] * 8

    def call(i):
        outs[i] = _post(base + "/query",
                        {"query": samples[i % len(samples)]["question"]})

    ts = [threading.Thread(target=call, args=(i,)) for i in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert all(o[0] == 200 and o[1]["hits"] for o in outs)


def test_error_paths(http_app):
    base, _ = http_app
    assert _post(base + "/query", {})[0] == 400
    assert _post(base + "/query_batch", {"queries": "nope"})[0] == 400
    assert _post(base + "/nope", {})[0] == 404
    assert _post(base + "/answer", {"question": "x"})[0] == 404  # --qa off
    code, out = _get(base + "/healthz")
    assert code == 200 and out["stats"]["queries"] > 0


def test_build_engine_from_packed_index(tmp_path):
    samples = SyntheticHotpotQALoader({"count": 6, "seed": 3}).load()
    corpus = SentenceCorpus.from_hotpotqa(samples)
    build_packed_index(corpus, embed_dim=32, embed_dtype="float32",
                       out_dir=str(tmp_path / "packed"))

    class Args:
        index = str(tmp_path / "packed")
        settings = ""
        top_k = 5
        max_batch = 64

    eng, n_docs, _ = build_engine(Args())
    assert n_docs == len(corpus)
    res = eng.query_batch([samples[0]["question"]])
    hits = eng.hydrate_hits(res, 0)
    assert hits and hits[0].id.startswith("sent::")
