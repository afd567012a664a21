"""Device ops vs NumPy oracles: top-k, BM25, graph expansion, fusion, semantic."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from a_modular_rag_framework_tpu.ops.bm25 import Bm25DeviceIndex, bm25_scores
from a_modular_rag_framework_tpu.ops.fusion import fuse_channels, minmax_normalize
from a_modular_rag_framework_tpu.ops.graph import (
    build_neighbor_table,
    expand_frontier,
    hop_decay_table,
)
from a_modular_rag_framework_tpu.ops.semantic import semantic_edges
from a_modular_rag_framework_tpu.eval.host_reference import bm25_oracle
from a_modular_rag_framework_tpu.ops.topk import (
    dense_topk,
    dense_topk_exact_tiled,
    dense_topk_xla,
)


# ---------------- oracles (independent reimplementations) ----------------


def bfs_decay_oracle(n, edges, seeds, window):
    """Host BFS with hop decay (reference expand_qmatch_neighbors semantics)."""
    from collections import deque

    adj = {i: set() for i in range(n)}
    for s, t in edges:
        adj[s].add(t)
        adj[t].add(s)
    dist = {s: 0 for s in seeds}
    q = deque((s, 0) for s in seeds)
    while q:
        u, d = q.popleft()
        if d >= window:
            continue
        for v in adj[u]:
            if v not in dist:
                dist[v] = d + 1
                q.append((v, d + 1))
    decay = hop_decay_table(max(window, 0))
    scores = np.zeros(n, dtype=np.float32)
    for u, d in dist.items():
        scores[u] = decay[d]
    return scores


# ---------------- dense top-k ----------------


def test_dense_topk_xla_matches_numpy(rng):
    Q = rng.standard_normal((4, 32), dtype=np.float32)
    D = rng.standard_normal((500, 32), dtype=np.float32)
    s, i = dense_topk_xla(jnp.asarray(Q), jnp.asarray(D), 10, precision=jax.lax.Precision.HIGHEST)
    ref = Q @ D.T
    ref_ids = np.argsort(-ref, axis=1)[:, :10]
    np.testing.assert_array_equal(np.asarray(i), ref_ids)
    np.testing.assert_allclose(np.asarray(s), np.take_along_axis(ref, ref_ids, 1), rtol=1e-5)


# the exact paths, each checked against NumPy; the tiled path at a tile
# count that leaves a ragged last tile
EXACT_PATHS = {
    "xla": lambda q, d, k: dense_topk_xla(q, d, k),
    "tiled": lambda q, d, k: dense_topk_exact_tiled(q, d, k, n_tiles=7),
}


def _numpy_topk(q, d, k):
    """Exact top-k in float64, ties by ascending id (lax.top_k's order)."""
    s = np.asarray(q, np.float64) @ np.asarray(d, np.float64).T
    ids = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(s, ids, 1), ids


@pytest.mark.parametrize("path", sorted(EXACT_PATHS))
def test_dense_topk_exact_paths_match_numpy(rng, path):
    Q = rng.standard_normal((4, 32), dtype=np.float32)
    D = rng.standard_normal((300, 32), dtype=np.float32)  # ragged tiles
    s, i = EXACT_PATHS[path](jnp.asarray(Q), jnp.asarray(D), 8)
    s_ref, i_ref = _numpy_topk(Q, D, 8)
    np.testing.assert_array_equal(np.asarray(i), i_ref)
    np.testing.assert_allclose(np.asarray(s), s_ref, rtol=1e-5)


@pytest.mark.parametrize("path", sorted(EXACT_PATHS))
def test_dense_topk_all_negative_scores(rng, path):
    """Tile padding (NEG_INF columns) must not beat real negative
    candidates."""
    Q = np.abs(rng.standard_normal((3, 16), dtype=np.float32))
    D = -np.abs(rng.standard_normal((100, 16), dtype=np.float32))
    s, i = EXACT_PATHS[path](jnp.asarray(Q), jnp.asarray(D), 7)
    s_ref, i_ref = _numpy_topk(Q, D, 7)
    assert (np.asarray(s) < 0).all()
    np.testing.assert_array_equal(np.asarray(i), i_ref)
    np.testing.assert_allclose(np.asarray(s), s_ref, rtol=1e-5)


@pytest.mark.parametrize("path", sorted(EXACT_PATHS))
def test_dense_topk_bf16_storage(rng, path):
    """bf16 corpus rows: queries are rounded to bf16 and products
    accumulate in f32, so the result is NumPy's on the rounded values."""
    Q = rng.standard_normal((2, 16), dtype=np.float32)
    D = rng.standard_normal((128, 16), dtype=np.float32)
    Db = jnp.asarray(D, dtype=jnp.bfloat16)
    s, i = EXACT_PATHS[path](jnp.asarray(Q), Db, 5)
    Qr = np.asarray(jnp.asarray(Q, dtype=jnp.bfloat16).astype(jnp.float32))
    s_ref, i_ref = _numpy_topk(Qr, np.asarray(Db.astype(jnp.float32)), 5)
    assert np.asarray(s).dtype == np.float32
    np.testing.assert_array_equal(np.asarray(i), i_ref)
    np.testing.assert_allclose(np.asarray(s), s_ref, rtol=1e-5)


# ---------------- BM25 ----------------

CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "a fast auburn fox leaped over a sleepy hound",
    "the dog sat quietly in the sun",
    "quantum computing uses qubits for parallel computation",
    "the fox is quick and the fox is clever",
    "slow green turtles walk under the warm sun",
]


@pytest.mark.parametrize("merge", ["max", "sum"])
def test_bm25_matches_oracle(merge):
    idx = Bm25DeviceIndex.build(CORPUS)
    queries = ["quick fox", "the sun dog", "qubits"]
    tids = idx.encode_query_terms(queries, max_terms=8)
    dev = idx.device_arrays()
    got = np.asarray(
        bm25_scores(jnp.asarray(tids), dev["doc_ids"], dev["tfs"], dev["row_ptr"],
                    dev["df"], dev["doc_lens"], n_docs=idx.n_docs, cap=16, merge=merge)
    )
    want = bm25_oracle(CORPUS, queries, merge=merge)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_bm25_duplicate_query_terms_count_twice():
    idx = Bm25DeviceIndex.build(CORPUS)
    dev = idx.device_arrays()
    t1 = idx.encode_query_terms(["fox"], max_terms=8)
    t2 = idx.encode_query_terms(["fox fox"], max_terms=8)
    s1 = np.asarray(bm25_scores(jnp.asarray(t1), dev["doc_ids"], dev["tfs"], dev["row_ptr"],
                                dev["df"], dev["doc_lens"], n_docs=idx.n_docs, cap=16))
    s2 = np.asarray(bm25_scores(jnp.asarray(t2), dev["doc_ids"], dev["tfs"], dev["row_ptr"],
                                dev["df"], dev["doc_lens"], n_docs=idx.n_docs, cap=16))
    np.testing.assert_allclose(s2, 2 * s1, rtol=1e-5)


def test_bm25_unknown_terms_score_zero():
    idx = Bm25DeviceIndex.build(CORPUS)
    dev = idx.device_arrays()
    tids = idx.encode_query_terms(["zzz unknown words"], max_terms=8)
    assert (tids == -1).all()
    s = np.asarray(bm25_scores(jnp.asarray(tids), dev["doc_ids"], dev["tfs"], dev["row_ptr"],
                               dev["df"], dev["doc_lens"], n_docs=idx.n_docs, cap=16))
    assert (s == 0).all()


# ---------------- graph expansion ----------------


def test_expand_frontier_matches_bfs_oracle(rng):
    n, window = 40, 3
    edges = [(int(a), int(b)) for a, b in rng.integers(0, n, size=(60, 2)) if a != b]
    seeds = [0, 7]
    nbrs = build_neighbor_table(n, np.array([e[0] for e in edges]),
                                np.array([e[1] for e in edges]), max_degree=16)
    seed_mask = np.zeros(n, dtype=bool)
    seed_mask[seeds] = True
    scores, _ = expand_frontier(jnp.asarray(nbrs), jnp.asarray(seed_mask), window=window)
    want = bfs_decay_oracle(n, edges, seeds, window)
    np.testing.assert_allclose(np.asarray(scores), want, rtol=1e-6)


def test_expand_frontier_window_zero_scores_only_seeds():
    nbrs = build_neighbor_table(5, np.array([0, 1]), np.array([1, 2]), max_degree=4)
    seed_mask = np.array([True, False, False, False, False])
    scores, _ = expand_frontier(jnp.asarray(nbrs), jnp.asarray(seed_mask), window=0)
    np.testing.assert_allclose(np.asarray(scores), [1, 0, 0, 0, 0])


def test_expand_frontier_capped_matches_dense_when_cap_sufficient(rng):
    n, window = 30, 2
    edges = [(int(a), int(b)) for a, b in rng.integers(0, n, size=(50, 2)) if a != b]
    nbrs = build_neighbor_table(n, np.array([e[0] for e in edges]),
                                np.array([e[1] for e in edges]), max_degree=16)
    seed_mask = np.zeros(n, dtype=bool)
    seed_mask[3] = True
    s_dense, _ = expand_frontier(jnp.asarray(nbrs), jnp.asarray(seed_mask), window=window)
    s_cap, _ = expand_frontier(jnp.asarray(nbrs), jnp.asarray(seed_mask),
                               window=window, frontier_cap=n)
    np.testing.assert_allclose(np.asarray(s_cap), np.asarray(s_dense))


def test_hop_decay_schedule():
    np.testing.assert_allclose(hop_decay_table(5), [1.0, 0.7, 0.5, 0.4, 0.3, 0.2])
    np.testing.assert_allclose(hop_decay_table(9)[-1], 0.1)  # floor at 0.1


# ---------------- fusion ----------------


def test_minmax_matches_reference_semantics():
    s = jnp.array([1.0, 3.0, 2.0, 99.0])
    p = jnp.array([True, True, True, False])
    out = np.asarray(minmax_normalize(s, p))
    np.testing.assert_allclose(out, [0.0, 1.0, 0.5, 0.0])
    # degenerate pool -> all zeros (reference _minmax_norm)
    out = np.asarray(minmax_normalize(jnp.array([2.0, 2.0]), jnp.array([True, True])))
    np.testing.assert_allclose(out, [0.0, 0.0])


def test_fuse_channels_oracle():
    # 3 channels over 6 docs; mirror the reference fuse loop by hand
    text = np.array([0.0, 5.0, 2.0, 0.0, 1.0, 0.0])
    text_p = np.array([False, True, True, False, True, False])
    graph = np.array([0.7, 0.0, 1.0, 0.0, 0.0, 0.5])
    graph_p = np.array([True, False, True, False, False, True])
    dense = np.array([0.1, 0.9, 0.0, 0.0, 0.4, 0.0])
    dense_p = np.array([True, True, False, False, True, False])
    alphas = np.array([0.4, 0.2, 0.4], dtype=np.float32)

    def norm(v, p):
        vals = v[p]
        if len(vals) == 0 or vals.max() <= vals.min():
            return np.zeros_like(v)
        out = np.where(p, (v - vals.min()) / (vals.max() - vals.min()), 0.0)
        return out

    want = alphas[0] * norm(text, text_p) + alphas[1] * norm(graph, graph_p) + alphas[2] * norm(dense, dense_p)
    union = text_p | graph_p | dense_p

    top_s, top_i, _ = fuse_channels(
        jnp.asarray(np.stack([text, graph, dense]), dtype=jnp.float32),
        jnp.asarray(np.stack([text_p, graph_p, dense_p])),
        jnp.asarray(alphas),
        k=6,
    )
    top_s, top_i = np.asarray(top_s), np.asarray(top_i)
    # doc 3 is in no pool -> must be padded out
    assert 3 not in top_i.tolist() or top_i.tolist().index(3) >= union.sum()
    for s, i in zip(top_s, top_i):
        if i >= 0:
            np.testing.assert_allclose(s, want[i], rtol=1e-5)
    # ranking matches
    want_order = np.argsort(-want[union.nonzero()[0]])
    got_valid = [i for i in top_i if i >= 0]
    assert got_valid == [int(union.nonzero()[0][j]) for j in want_order][: len(got_valid)]


# ---------------- semantic edges ----------------


def test_semantic_edges_matches_pairwise_cosine(rng):
    emb = rng.standard_normal((12, 8)).astype(np.float32)
    emb[3] = 0.0  # zero-norm row must produce no edges
    thr = 0.3
    got = {(i, j): s for i, j, s in semantic_edges(emb, threshold=thr)}
    for i in range(12):
        for j in range(i + 1, 12):
            ni, nj = np.linalg.norm(emb[i]), np.linalg.norm(emb[j])
            sim = 0.0 if ni == 0 or nj == 0 else float(emb[i] @ emb[j] / (ni * nj))
            if sim >= thr and ni > 0 and nj > 0:
                assert (i, j) in got and abs(got[(i, j)] - sim) < 1e-4
            else:
                assert (i, j) not in got


def test_semantic_edges_empty_and_single():
    assert semantic_edges(np.zeros((0, 4), dtype=np.float32), threshold=0.5) == []
    assert semantic_edges(np.ones((1, 4), dtype=np.float32), threshold=0.5) == []


def test_capped_weighted_expansion_matches_dense(rng):
    from a_modular_rag_framework_tpu.ops.graph import (
        expand_frontier_weighted,
        expand_frontier_weighted_capped,
    )

    n = 50
    edges = [(int(a), int(b)) for a, b in rng.integers(0, n, size=(80, 2)) if a != b]
    nbrs = build_neighbor_table(n, np.array([e[0] for e in edges]),
                                np.array([e[1] for e in edges]), max_degree=16)
    seeds = np.zeros(n, dtype=np.float32)
    seeds[[2, 9, 30]] = [1.0, 0.5, 0.8]
    dense = expand_frontier_weighted(jnp.asarray(nbrs), jnp.asarray(seeds), window=2)
    capped = expand_frontier_weighted_capped(jnp.asarray(nbrs), jnp.asarray(seeds),
                                             window=2, frontier_cap=n)
    np.testing.assert_allclose(np.asarray(capped), np.asarray(dense), rtol=1e-6)
    # tiny cap still propagates from the strongest seed
    capped1 = np.asarray(expand_frontier_weighted_capped(
        jnp.asarray(nbrs), jnp.asarray(seeds), window=1, frontier_cap=1))
    for b in nbrs[2]:
        if b >= 0:
            assert capped1[b] >= 0.7 - 1e-6


def test_expand_frontier_weighted_batched_matches_vmapped(rng):
    """The memory-safe batched formulation == the vmapped row-gather one,
    and uniform seeds reduce to expand_frontier's decay(distance)."""
    from a_modular_rag_framework_tpu.ops.graph import (
        build_neighbor_table,
        expand_frontier,
        expand_frontier_weighted,
        expand_frontier_weighted_batched,
    )

    N, deg, B = 200, 5, 8
    src = rng.integers(0, N, 500)
    dst = rng.integers(0, N, 500)
    nbrs = jnp.asarray(build_neighbor_table(N, src, dst, deg))
    seeds = (rng.random((B, N)).astype(np.float32)
             * (rng.random((B, N)) < 0.03))
    ref = np.stack([np.asarray(expand_frontier_weighted(
        nbrs, jnp.asarray(s), window=2)) for s in seeds])
    got = np.asarray(expand_frontier_weighted_batched(
        nbrs, jnp.asarray(seeds), window=2))
    np.testing.assert_allclose(got, ref, rtol=1e-6)

    mask = seeds[0] > 0
    s_ref, _ = expand_frontier(nbrs, jnp.asarray(mask), window=2)
    got_u = np.asarray(expand_frontier_weighted_batched(
        nbrs, jnp.asarray(mask[None].astype(np.float32)), window=2))[0]
    np.testing.assert_allclose(got_u, np.asarray(s_ref), rtol=1e-6)

    # bf16 wave: f32 values within bf16 rounding, f32 output dtype, and the
    # REACHED SET (nonzero support) identical — the property retrieval
    # ranking actually depends on
    got16 = np.asarray(expand_frontier_weighted_batched(
        nbrs, jnp.asarray(seeds), window=2, wave_dtype="bfloat16"))
    assert got16.dtype == np.float32
    np.testing.assert_allclose(got16, ref, rtol=1e-2, atol=1e-3)
    np.testing.assert_array_equal(got16 > 0, ref > 0)


def test_dense_topk_approx_matches_exact_on_cpu(rng):
    """XLA lowers approx_max_k to an exact sort on the CPU and the GPU, so
    the approx path must equal the oracle there."""
    from a_modular_rag_framework_tpu.ops.topk import dense_topk_approx

    Q = rng.standard_normal((4, 32), dtype=np.float32)
    D = rng.standard_normal((300, 32), dtype=np.float32)
    s_a, i_a = dense_topk_approx(jnp.asarray(Q), jnp.asarray(D), 8)
    s_x, i_x = dense_topk_xla(jnp.asarray(Q), jnp.asarray(D), 8)
    np.testing.assert_array_equal(np.asarray(i_a), np.asarray(i_x))


def test_compact_weighted_expansion_matches_dense(rng):
    """The N-independent compact expansion == the dense [N] formulation
    whenever cap/out_k cover the reached set (then it is exact, per
    docstring), including multi-hop decay and -1/zero-value seed padding."""
    from a_modular_rag_framework_tpu.ops.graph import (
        expand_frontier_weighted,
        expand_frontier_weighted_compact,
    )

    N, B, S = 200, 6, 8
    src = rng.integers(0, N, 500)
    dst = rng.integers(0, N, 500)
    nbrs = jnp.asarray(build_neighbor_table(N, src, dst, 16))
    seed_ids = rng.integers(0, N, size=(B, S)).astype(np.int32)
    seed_ids[0, :3] = -1
    seed_vals = rng.random((B, S)).astype(np.float32)
    seed_vals[1, :2] = 0.0

    for window in (0, 1, 2, 3):
        dense = []
        for b in range(B):
            sv = np.zeros((N,), np.float32)
            for j in range(S):
                if seed_ids[b, j] >= 0 and seed_vals[b, j] > 0:
                    sv[seed_ids[b, j]] = max(sv[seed_ids[b, j]],
                                             seed_vals[b, j])
            dense.append(np.asarray(expand_frontier_weighted(
                nbrs, jnp.asarray(sv), window=window)))
        dense = np.stack(dense)
        g_s, g_i = expand_frontier_weighted_compact(
            nbrs, jnp.asarray(seed_ids), jnp.asarray(seed_vals),
            window=window, cap=N, out_k=N)
        rec = np.zeros((B, N), np.float32)
        g_s, g_i = np.asarray(g_s), np.asarray(g_i)
        for b in range(B):
            for v, i in zip(g_s[b], g_i[b]):
                if i >= 0:
                    rec[b, i] = v
        np.testing.assert_allclose(rec, dense, atol=1e-6)


def test_compact_expansion_small_cap_keeps_strongest(rng):
    """With cap=1 only the strongest wave node propagates — the same
    weakest-node truncation contract as expand_frontier_weighted_capped."""
    from a_modular_rag_framework_tpu.ops.graph import (
        expand_frontier_weighted_compact,
    )

    # star: 0-1, 0-2; chain 3-4. Seeds: 0 (strong), 3 (weak).
    nbrs = jnp.asarray(build_neighbor_table(
        5, np.array([0, 0, 3]), np.array([1, 2, 4]), 4))
    seed_ids = np.array([[0, 3]], dtype=np.int32)
    seed_vals = np.array([[1.0, 0.4]], dtype=np.float32)
    g_s, g_i = expand_frontier_weighted_compact(
        nbrs, jnp.asarray(seed_ids), jnp.asarray(seed_vals),
        window=1, cap=1, out_k=5)
    got = {int(i): float(v) for v, i in zip(np.asarray(g_s)[0],
                                            np.asarray(g_i)[0]) if i >= 0}
    # seeds keep decay0 scores; only node 0's neighbors get hop-1 scores
    assert got[0] == pytest.approx(1.0)
    assert got[3] == pytest.approx(0.4)
    assert got[1] == pytest.approx(0.7) and got[2] == pytest.approx(0.7)
    assert 4 not in got  # node 3 was truncated from the propagating wave


@pytest.mark.parametrize("path", sorted(EXACT_PATHS))
def test_dense_topk_adversarial_ascending(path):
    """Ascending-score corpus: every later tile beats every earlier one."""
    q = np.ones((4, 8), np.float32)
    d = np.linspace(0, 1, 512, dtype=np.float32)[:, None] * np.ones(
        (512, 8), np.float32)
    s, i = EXACT_PATHS[path](jnp.asarray(q), jnp.asarray(d), 10)
    np.testing.assert_array_equal(np.asarray(i),
                                  np.tile(np.arange(511, 501, -1), (4, 1)))
    np.testing.assert_allclose(np.asarray(s), _numpy_topk(q, d, 10)[0],
                               rtol=1e-5)


@pytest.mark.parametrize("path", sorted(EXACT_PATHS))
def test_dense_topk_tie_order_matches_lax_topk(rng, path):
    """Duplicated corpus rows, with tie groups split across tiles: tied
    scores keep ascending ids, lax.top_k's tie order."""
    d = np.repeat(rng.standard_normal((50, 8)).astype(np.float32), 4, axis=0)
    q = rng.standard_normal((3, 8)).astype(np.float32)
    s, i = EXACT_PATHS[path](jnp.asarray(q), jnp.asarray(d), 12)
    np.testing.assert_array_equal(np.asarray(i), _numpy_topk(q, d, 12)[1])
    ref_s, ref_i = dense_topk_xla(jnp.asarray(q), jnp.asarray(d), 12)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(ref_i))


@pytest.mark.parametrize("path", sorted(EXACT_PATHS))
def test_dense_topk_shape_fuzz(rng, path):
    """Shapes that stress tiling: k above a tile, k == N, odd corpus
    sizes, more tiles than k."""
    for B, N, k in ((8, 700, 33), (16, 256, 5), (2, 2000, 200), (5, 130, 130)):
        q = rng.standard_normal((B, 24)).astype(np.float32)
        d = rng.standard_normal((N, 24)).astype(np.float32)
        s, i = EXACT_PATHS[path](jnp.asarray(q), jnp.asarray(d), k)
        s_ref, i_ref = _numpy_topk(q, d, k)
        np.testing.assert_array_equal(np.asarray(i), i_ref)
        np.testing.assert_allclose(np.asarray(s), s_ref, rtol=1e-4, atol=1e-5)


def test_dense_topk_tiled_rejects_k_above_n(rng):
    d = jnp.asarray(rng.standard_normal((10, 4)).astype(np.float32))
    with pytest.raises(ValueError):
        dense_topk_exact_tiled(d[:2], d, 11, n_tiles=4)


def test_dense_topk_dispatch_is_exact(rng):
    """The engine's entry point returns the oracle's result."""
    Q = rng.standard_normal((6, 16), dtype=np.float32)
    D = rng.standard_normal((333, 16), dtype=np.float32)
    s, i = dense_topk(jnp.asarray(Q), jnp.asarray(D), 9)
    s_ref, i_ref = _numpy_topk(Q, D, 9)
    np.testing.assert_array_equal(np.asarray(i), i_ref)
    np.testing.assert_allclose(np.asarray(s), s_ref, rtol=1e-5)


def test_reorder_hits_two_stage_fusion():
    """order_alphas re-ranks a selected top-k by a second weighting: the id
    SET is preserved, order follows the weighted channel norms, the
    reported score becomes the ordering score, pads sink to the end."""
    import jax.numpy as jnp

    from a_modular_rag_framework_tpu.ops.fusion import reorder_hits

    top_s = jnp.asarray([[0.9, 0.8, 0.7, 0.0]])
    top_i = jnp.asarray([[5, 3, 9, -1]], dtype=jnp.int32)
    # norms [B, 3, k]: text / graph / dense at each hit
    norms = jnp.asarray([[[0.1, 0.9, 0.5, 0.0],
                          [0.9, 0.1, 0.5, 0.0],
                          [0.1, 0.9, 0.5, 0.0]]])
    s2, i2, n2 = reorder_hits(top_s, top_i, norms, (0.4, 0.2, 0.4))
    s2, i2, n2 = np.asarray(s2), np.asarray(i2), np.asarray(n2)
    # ordering scores: id5 = .4*.1+.2*.9+.4*.1 = 0.26; id3 = .4*.9+.2*.1+.4*.9 = 0.74
    # id9 = 0.5 -> order [3, 9, 5], pad last
    assert i2[0].tolist() == [3, 9, 5, -1]
    assert s2[0][:3] == pytest.approx([0.74, 0.5, 0.26], abs=1e-6)
    # norms ride the permutation
    assert n2[0, 0].tolist() == pytest.approx([0.9, 0.5, 0.1, 0.0], abs=1e-6)


def test_engine_order_alphas_same_set_parity_order():
    """An engine with two-stage fusion returns the same hit SET as the
    single-stage engine with the selection alphas, ordered by the ordering
    alphas' fused score."""
    from a_modular_rag_framework_tpu.core.dataset_loader import (
        SyntheticHotpotQALoader,
    )
    from a_modular_rag_framework_tpu.engine.query_engine import (
        EngineConfig,
        QueryEngine,
    )
    from a_modular_rag_framework_tpu.index.builder import build_packed_index
    from a_modular_rag_framework_tpu.index.corpus import SentenceCorpus
    samples = SyntheticHotpotQALoader({"count": 24, "seed": 3,
                                       "unique_entities": True}).load()
    idx = build_packed_index(SentenceCorpus.from_hotpotqa(samples),
                             embed_dim=32, embed_dtype="float32")
    base = dict(top_k=10, pool_k=64, graph_window=2, bm25_term_topm=4096,
                batch_buckets=(32,), alpha_text=0.15, alpha_graph=0.7,
                alpha_dense=0.15, graph_wave_dtype="float32")
    qs = [s["question"] for s in samples]
    plain = QueryEngine(idx, config=EngineConfig(**base))
    two = QueryEngine(idx, config=EngineConfig(
        order_alphas=(0.4, 0.2, 0.4), **base))
    r1, r2 = plain.query_batch(qs), two.query_batch(qs)
    i1, i2 = np.asarray(r1.hits.ids), np.asarray(r2.hits.ids)
    s2 = np.asarray(r2.hits.scores)
    for b in range(len(qs)):
        assert set(i1[b].tolist()) == set(i2[b].tolist())
        live = s2[b][i2[b] >= 0]
        assert (np.diff(live) <= 1e-6).all()  # ranked by reported score
        # the ordering score is the 0.4/0.2/0.4 weighted norm sum
        n2 = np.asarray(r2.channel_norms)[:, b, :]  # [3, k]
        expect = 0.4 * n2[0] + 0.2 * n2[1] + 0.4 * n2[2]
        ok = i2[b] >= 0
        assert s2[b][ok] == pytest.approx(expect[ok], abs=1e-5)
    # sharded bit-parity with order_alphas is asserted on the tie-free
    # corpus by parallel.sharded_hybrid.dryrun_check (4th case); template
    # corpora like this one carry exact-tie groups where the two selection
    # orders legitimately differ.


def test_dense_topk_exact_tiled_matches_xla():
    """Two-level exact top-k == single-level lax.top_k on scores and id
    SETS (tie order across tiles may differ), incl. non-divisible N."""
    import jax.numpy as jnp

    from a_modular_rag_framework_tpu.ops.topk import (
        dense_topk_exact_tiled,
        dense_topk_xla,
    )

    rng = np.random.default_rng(3)
    for N, T in ((1000, 16), (1024, 8), (57, 4)):
        q = jnp.asarray(rng.standard_normal((9, 32)).astype(np.float32))
        d = jnp.asarray(rng.standard_normal((N, 32)).astype(np.float32))
        k = min(20, N)
        s1, i1 = dense_topk_xla(q, d, k)
        s2, i2 = dense_topk_exact_tiled(q, d, k, n_tiles=T)
        assert np.allclose(np.asarray(s1), np.asarray(s2), atol=1e-5)
        for b in range(9):
            assert set(np.asarray(i1)[b].tolist()) == set(np.asarray(i2)[b].tolist())


def test_canonical_pool_order_sorts_by_score_then_id():
    """Pools leave phase-1 in the order of its float sums; graph seeding
    breaks ties by position, so both engines put the pool in (score desc,
    id asc) order with invalid entries (score <= 0 or id < 0) last."""
    from a_modular_rag_framework_tpu.ops.bm25 import canonical_pool_order

    s = jnp.asarray([[0.5, 2.0, 0.5, 0.0, 2.0, 1.0, 3.0]], jnp.float32)
    i = jnp.asarray([[9, 7, 4, 1, 3, -1, 5]], jnp.int32)
    ps, pi = canonical_pool_order(s, i)
    assert np.asarray(pi)[0, :5].tolist() == [5, 3, 7, 4, 9]
    assert np.asarray(ps)[0, :5].tolist() == [3.0, 2.0, 2.0, 0.5, 0.5]
    # invalid entries keep their values, after the valid ones
    assert sorted(zip(np.asarray(ps)[0, 5:].tolist(),
                      np.asarray(pi)[0, 5:].tolist())) == [(0.0, 1), (1.0, -1)]
