"""Plain host reference of the hybrid retrieval semantics.

An independent reimplementation, in Python dicts and NumPy, of what the
reference project's hybrid retriever computes: exact BM25 over the whole
corpus (top-``pool`` positive pool), dense cosine over that pool,
per-channel min-max over each channel's own pool, alpha fusion, top-k. The
engine's device program is compared with it by the parity tests and by
``chip_smoke.py``; nothing here shares code with the engine beyond the
tokenizer and the hash features that define the corpus.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..models.hash_embed import hash_embed_numpy, tokenize

POOL = 200


def bm25_oracle(corpus, queries, k1=1.5, b=0.75, merge="max"):
    """Dict-based BM25 with the reference's exact formula: [N] scores,
    max- (or sum-) merged over ``queries``."""
    return HostReference(corpus, embed_dim=0, k1=k1, b=b).bm25(
        queries, merge=merge)


def _minmax(d: Dict[int, float]) -> Dict[int, float]:
    if not d:
        return {}
    vs = list(d.values())
    lo, hi = min(vs), max(vs)
    if hi <= lo:
        return {kk: 0.0 for kk in d}
    return {kk: (v - lo) / (hi - lo) for kk, v in d.items()}


class HostReference:
    """Corpus statistics built once; per-query scoring in float64."""

    def __init__(self, texts: Sequence[str], *, embed_dim: int = 64,
                 k1: float = 1.5, b: float = 0.75):
        self.k1, self.b = k1, b
        self.tf: Dict[str, Dict[int, int]] = {}
        self.doc_lens: List[int] = []
        for di, text in enumerate(texts):
            toks = tokenize(text)
            self.doc_lens.append(len(toks))
            for t in toks:
                self.tf.setdefault(t, {}).setdefault(di, 0)
                self.tf[t][di] += 1
        self.n = len(self.doc_lens)
        self.avgdl = sum(self.doc_lens) / self.n if self.n else 0.0
        self.emb = (hash_embed_numpy(list(texts), dim=embed_dim)
                    if embed_dim else None)
        self.embed_dim = embed_dim

    def _idf(self, t: str) -> float:
        n = len(self.tf.get(t, {}))
        return math.log((self.n - n + 0.5) / (n + 0.5) + 1.0)

    def bm25(self, queries: Sequence[str], merge: str = "max") -> np.ndarray:
        out = np.zeros((len(queries), self.n), dtype=np.float64)
        for qi, q in enumerate(queries):
            for t in tokenize(q):
                idf = self._idf(t)
                for di, f in self.tf.get(t, {}).items():
                    dl = self.doc_lens[di]
                    denom = f + self.k1 * (1 - self.b + self.b * (
                        dl / (self.avgdl or 1.0)))
                    out[qi, di] += idf * (f * (self.k1 + 1)) / (denom or 1.0)
        if merge == "max":
            return out.max(axis=0)
        return out.sum(axis=0)

    def _pool_and_dense(self, query: str, pool_k: int):
        bm25 = self.bm25([query])
        order = np.argsort(-bm25, kind="stable")
        pool = [int(i) for i in order[:pool_k] if bm25[i] > 0]
        qv = hash_embed_numpy([query], dim=self.embed_dim)[0]
        dense = {}
        for i in pool:
            d = np.linalg.norm(qv) * np.linalg.norm(self.emb[i])
            dense[i] = float(qv @ self.emb[i] / d) if d else 0.0
        return bm25, pool, dense

    def fused(self, query: str, *, alphas=(0.4, 0.2, 0.4), pool_k: int = POOL,
              graph: Dict[int, float] = None) -> Dict[int, float]:
        """Fused score of every candidate in the channel pools' union."""
        bm25, pool, dense = self._pool_and_dense(query, pool_k)
        nt = _minmax({i: float(bm25[i]) for i in pool})
        nd = _minmax(dense)
        ng = _minmax(graph or {})
        ids = set(pool) | set(ng)
        a_t, a_g, a_d = alphas
        return {i: a_t * nt.get(i, 0) + a_g * ng.get(i, 0)
                + a_d * nd.get(i, 0) for i in ids}

    @staticmethod
    def ranked(fused: Dict[int, float], k: int) -> List[Tuple[int, float]]:
        return sorted(fused.items(), key=lambda kv: (-kv[1], kv[0]))[:k]

    def graph_channel(self, next_table, seed_rows, window: int,
                      pool_k: int = POOL) -> Dict[int, float]:
        """BFS over next-in-doc chains (fwd+bwd) from the q_match seeds with
        hop decay 1.0/0.7/0.5 (reference graph_utils.py:58-129); the top
        ``pool_k`` by score."""
        decay = {0: 1.0, 1: 0.7, 2: 0.5}
        nbrs = np.asarray(next_table)
        graph: Dict[int, float] = {}
        frontier = list(seed_rows)
        seen = set(frontier)
        for r in frontier:
            graph[r] = decay[0]
        for hop in range(1, window + 1):
            nxt = []
            for r in frontier:
                for nb in nbrs[r]:
                    nb = int(nb)
                    if nb >= 0 and nb not in seen:
                        seen.add(nb)
                        graph[nb] = decay[hop]
                        nxt.append(nb)
            frontier = nxt
        return dict(sorted(graph.items(),
                           key=lambda kv: (-kv[1], kv[0]))[:pool_k])


def host_reference_pipeline(idx, query: str, k: int = 10,
                            ref: HostReference = None) -> List[str]:
    """Reference-semantics hybrid retrieval on the host (text+dense only,
    0.4/0.4 fusion): top-k hit ids."""
    ref = ref or HostReference(idx.corpus.texts(), embed_dim=64)
    ranked = ref.ranked(ref.fused(query, alphas=(0.4, 0.0, 0.4)), k)
    return [idx.corpus.hit_id(i) for i, _ in ranked]


def host_reference_pipeline_3ch(idx, sample, seed_rows, k: int = 10,
                                window: int = 2,
                                ref: HostReference = None) -> List[str]:
    """Reference-semantics hybrid with ALL THREE channels: BM25 pool +
    dense cosine over the pool + graph BFS from the per-question q_match
    seeds, min-max per channel, 0.4/0.2/0.4 fusion: top-k hit ids."""
    ref = ref or HostReference(idx.corpus.texts(), embed_dim=64)
    graph = ref.graph_channel(idx.graph_next, seed_rows, window)
    ranked = ref.ranked(ref.fused(sample["question"], graph=graph), k)
    return [idx.corpus.hit_id(i) for i, _ in ranked]


def qmatch_seed_rows_for_sample(idx, sample) -> List[int]:
    """Per-question q_match seeds: the sample's own context sentences
    sharing >= 1 token with the question (EdgeBuilder q_match semantics,
    reference edge_builder.py:134-143), mapped to corpus rows."""
    q_terms = set(tokenize(sample["question"]))
    by = idx.corpus.row_by_title_sid()
    rows = []
    for title, sents in sample["context"]:
        for sid, text in enumerate(sents):
            if q_terms & set(tokenize(text)):
                row = by.get((title, sid))
                if row is not None:
                    rows.append(int(row))
    return sorted(set(rows))


def compare_topk(got_ids, got_scores, fused: Dict[int, float], k: int,
                 tol: float) -> Tuple[bool, str]:
    """Engine top-k vs the reference's fused scores. Rank by rank, the
    engine's id must be the reference's, or a candidate whose reference
    score lies within ``tol`` of the reference's score at that rank (an
    order the score gap cannot decide). Every engine score must match the
    reference score of its id within ``tol``. -> (ok, reason)."""
    want = HostReference.ranked(fused, k)
    got = [(int(i), float(s)) for i, s in zip(got_ids, got_scores) if i >= 0]
    if len(got) != len(want):
        return False, f"{len(got)} hits, reference has {len(want)}"
    for r, ((gi, gs), (wi, ws)) in enumerate(zip(got, want)):
        if gi not in fused:
            return False, f"rank {r}: id {gi} is in no reference pool"
        if abs(gs - fused[gi]) > tol:
            return False, (f"rank {r}: id {gi} scored {gs:.7f}, reference "
                           f"{fused[gi]:.7f}")
        if gi != wi and abs(fused[gi] - ws) > tol:
            return False, (f"rank {r}: id {gi} (ref {fused[gi]:.7f}) in "
                           f"place of {wi} (ref {ws:.7f})")
    return True, ""
