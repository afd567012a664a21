"""Streaming index build: ingest -> chunk -> embed -> pack.

The device-side replacement for the reference's ingest path
(my_code/ingest_hotpotqa.py:46-87 writes docs.jsonl; BM25 re-indexes from it
at every construction, text_index.py:32-53; embeddings came from a remote
API at query time). Here ingest produces one `PackedIndex` artifact:

  1. sentences stream in fixed-size batches;
  2. the encoder embeds each batch as one device program — host featurizes
     batch i+1 while the device works on batch i (JAX async dispatch);
  3. BM25 CSR postings and the sentence graph (next-in-doc chains +
     shared-entity links) are built host-side in the same pass;
  4. everything is packed + checksummed to disk, ready to memory-map
     straight back to the device.

Reports passages/sec (the BASELINE.json index-build metric).
"""
from __future__ import annotations

import time
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

from ..models.hash_embed import HashEmbedEncoder
from ..utils.entity_linker import simple_ner
from .corpus import SentenceCorpus
from .packed import PackedIndex
from ..ops.bm25 import Bm25DeviceIndex


def build_sentence_graph(
    corpus: SentenceCorpus, max_degree: int = 32, entity_chain_cap: int = 64,
    use_native: bool = True, texts: Optional[List[str]] = None,
) -> Dict[str, np.ndarray]:
    """Two sentence-adjacency channel tables, each [N, deg] int32 (-1 pad).

    The corpus-level analogue of the per-question graph's edge channels:
      - ``next_in_doc`` [N, 2]: (title, sid) <-> (title, sid+1) chains —
        exactly the fwd+bwd adjacency the reference BFS walks
        (graph_utils.py:49-51,123). Parity mode uses only this table.
      - ``entity`` [N, max_degree]: sentences mentioning the same
        proper-noun span, chained in corpus order (chains, not cliques, so
        common entities don't blow up degree; BFS reaches the whole group in
        <= window hops). This is the entity-link adjacency for the 2-hop
        engine (BASELINE.json config 3).

    ``texts`` overrides the per-row text used for ENTITY extraction only
    (`build_packed_index` passes title-augmented texts when
    ``index_titles`` is set, so pronoun-heavy natural sentences join their
    own document's entity chain); doc adjacency keys on (title, sid)
    regardless.
    """
    n = len(corpus)

    def make(deg: int):
        return np.full((n, deg), -1, dtype=np.int32), np.zeros(n, dtype=np.int32)

    def add(nbrs, counts, a: int, b: int) -> None:
        if a == b:
            return
        deg = nbrs.shape[1]
        if counts[a] < deg and b not in nbrs[a, : counts[a]]:
            nbrs[a, counts[a]] = b
            counts[a] += 1
        if counts[b] < deg and a not in nbrs[b, : counts[b]]:
            nbrs[b, counts[b]] = a
            counts[b] += 1

    next_nbrs, next_counts = make(2)
    by_title_sid = corpus.row_by_title_sid()
    for row, d in enumerate(corpus.docs):
        nxt = by_title_sid.get((d.get("title"), (d.get("sent_id") or 0) + 1))
        if nxt is not None and nxt != row:
            # direct insertion — equivalent to add() on well-formed data:
            # each row has at most one successor and one predecessor, so a
            # duplicate is impossible, and add()'s membership scan per call
            # was ~half the graph stage's wall time at 2.3M rows. The cap
            # guard stays for corpora with duplicate (title, sent_id) keys
            # (several rows can then resolve to the same successor).
            ca = int(next_counts[row])
            if ca < 2 and (ca == 0 or int(next_nbrs[row, 0]) != nxt):
                next_nbrs[row, ca] = nxt
                next_counts[row] = ca + 1
            cb = int(next_counts[nxt])
            if cb < 2 and (cb == 0 or int(next_nbrs[nxt, 0]) != row):
                next_nbrs[nxt, cb] = row
                next_counts[nxt] = cb + 1

    ent_texts = (texts if texts is not None
                 else [d.get("text", "") for d in corpus.docs])
    if use_native:
        try:
            from ..native import entity_graph_native
        except ImportError:  # pragma: no cover - toolchain-less environments
            entity_graph_native = None
        if entity_graph_native is not None:
            ent_nbrs = entity_graph_native(
                ent_texts,
                max_degree=max_degree, entity_chain_cap=entity_chain_cap)
            if ent_nbrs is not None:
                return {"next_in_doc": next_nbrs, "entity": ent_nbrs}

    ent_nbrs, ent_counts = make(max_degree)
    entity_rows: Dict[str, List[int]] = {}
    for row, row_text in enumerate(ent_texts):
        # Title mentions stay in: a sentence naming entity B must link to the
        # sentences of the document titled B — that's the bridge that makes
        # 2-hop questions reachable (hop 1 finds "A worked with B", hop 2
        # needs B's own document).
        # ordered dedup, NOT set(): set iteration follows the randomized
        # str hash, so two processes could insert entity groups in
        # different orders and — at degree-saturated rows — pack different
        # neighbors. First-appearance order makes the build reproducible
        # (and is what the native C++ builder implements).
        for ent in dict.fromkeys(simple_ner(row_text)):
            lst = entity_rows.setdefault(ent, [])
            if len(lst) < entity_chain_cap:
                lst.append(row)
    for rows in entity_rows.values():
        # star: every mention links to the entity's first row (its "hub" —
        # for a titled document that's the doc's first sentence), so any two
        # mentions are <= 2 hops apart; plus a consecutive chain as fallback
        # when the hub's degree saturates.
        hub = rows[0]
        for r in rows[1:]:
            add(ent_nbrs, ent_counts, hub, r)
        for a, b in zip(rows, rows[1:]):
            add(ent_nbrs, ent_counts, a, b)
    return {"next_in_doc": next_nbrs, "entity": ent_nbrs}


def build_packed_index(
    corpus: SentenceCorpus,
    *,
    encoder: Optional[Any] = None,
    embed_dim: int = 64,
    embed_dtype: str = "bfloat16",
    embed_batch: int = 1024,
    bm25_k1: float = 1.5,
    bm25_b: float = 0.75,
    bm25_phrase_tokens: bool = True,
    graph_max_degree: int = 32,
    index_titles: bool = False,
    out_dir: Optional[str] = None,
    progress: Optional[Any] = None,
) -> PackedIndex:
    """Run the streaming build; optionally persist to ``out_dir``.

    ``index_titles``: prepend each sentence's document TITLE to the text
    every channel indexes (BM25 postings, embeddings, entity graph). On
    natural discourse a document's later sentences rarely repeat its
    subject ("He was born in Cincinnati ..."), so without the title they
    are unreachable by the very tokens that name them — the standard
    HotpotQA practice is to index title+sentence. Off by default: the
    synthetic corpora name their subject in every sentence, and the
    reference indexes bare text (text_index.py:40-50), so parity holds.
    Hit ids, displayed text, and doc adjacency are unaffected.
    """
    if encoder is None:
        encoder = HashEmbedEncoder(dim=embed_dim)

    texts = corpus.texts()
    if index_titles:
        texts = [f"{d.get('title') or ''} . {t}" if d.get("title") else t
                 for d, t in zip(corpus.docs, texts)]
    n = len(texts)
    t0 = time.time()

    # --- embed: pipelined host featurize -> device encode ---
    # every batch is padded to embed_batch so exactly ONE program shape
    # compiles (the trailing partial batch otherwise costs a recompile)
    shards: List[np.ndarray] = []
    pending = None  # device result not yet materialized (async dispatch)
    pending_rows = 0
    for i in range(0, n, embed_batch):
        batch = texts[i : i + embed_batch]
        rows = len(batch)
        if rows < embed_batch:
            batch = batch + [""] * (embed_batch - rows)
        # encode_texts picks the right execution: vectorized host path for
        # the hash encoder (device dispatch would cost compile + transfer
        # round-trips), jitted device batch for learned encoders. Device
        # results are JAX arrays whose materialization below overlaps with
        # the next batch's featurization (async dispatch).
        fut = encoder.encode_texts(batch)
        if pending is not None:
            shards.append(np.asarray(pending)[:pending_rows])
        pending, pending_rows = fut, rows
        if progress:
            progress(min(i + embed_batch, n), n, "embed")
    if pending is not None:
        shards.append(np.asarray(pending)[:pending_rows])
    emb = np.concatenate(shards, axis=0) if shards else np.zeros((0, embed_dim), np.float32)
    t_embed = time.time() - t0

    # --- sparse structures (host pass) ---
    t1 = time.time()
    bm25 = Bm25DeviceIndex.build(texts, k1=bm25_k1, b=bm25_b,
                                 phrase_tokens=bm25_phrase_tokens)
    t_bm25 = time.time() - t1
    t2 = time.time()
    graph_tables = build_sentence_graph(
        corpus, max_degree=graph_max_degree,
        texts=texts if index_titles else None)
    t_graph = time.time() - t2

    total = time.time() - t0
    stats = {
        "build_stats": {
            "passages": n,
            "index_titles": bool(index_titles),
            "total_sec": round(total, 3),
            "embed_sec": round(t_embed, 3),
            "bm25_sec": round(t_bm25, 3),
            "graph_sec": round(t_graph, 3),
            "passages_per_sec": round(n / total, 1) if total > 0 else 0.0,
        }
    }

    idx = PackedIndex(
        corpus=corpus,
        embeddings=emb,
        embed_dtype=embed_dtype,
        bm25=bm25,
        graph_next=graph_tables["next_in_doc"],
        graph_entity=graph_tables["entity"],
        manifest=stats,
    )
    if out_dir:
        idx.save(out_dir)
    return idx
