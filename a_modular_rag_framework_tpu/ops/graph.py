"""Multi-hop graph frontier expansion on device.

Replaces the reference's host BFS over python adjacency dicts
(graph_utils.py:58-129) with static-shaped frontier propagation over a
padded adjacency table resident in HBM.

Semantics parity: every node's score is ``decay(d)`` where ``d`` is its BFS
distance from the nearest seed, capped at ``window`` hops, with the decay
schedule 1.0 / 0.7 / 0.5 / max(0.5 - 0.1*(d-2), 0.1).

Two propagation modes share the hop loop:

- dense (default): each hop scatters all neighbors of the current frontier
  mask — O(N * deg) per hop, exact, right for per-question graphs.
- capacity-bounded (``frontier_cap``): each hop keeps only the top-C frontier
  nodes (by current score) and gathers just their adjacency rows —
  O(C * deg) per hop, the scalable 2-hop engine for corpus-level
  entity-link graphs (BASELINE.json config 3). Exact whenever the true
  frontier fits in C.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

UNREACHED = jnp.int32(0x7FFFFFF)


def hop_decay_table(max_hops: int) -> np.ndarray:
    """decay(d) for d = 0..max_hops (reference graph_utils.py:87-94)."""
    out = []
    for d in range(max_hops + 1):
        if d == 0:
            out.append(1.0)
        elif d == 1:
            out.append(0.7)
        elif d == 2:
            out.append(0.5)
        else:
            out.append(max(0.5 - 0.1 * (d - 2), 0.1))
    return np.array(out, dtype=np.float32)


@functools.partial(jax.jit, static_argnames=("window", "frontier_cap"))
def expand_frontier(
    neighbors: jax.Array,  # [N, deg] int32, -1 padded (undirected: fwd+bwd merged)
    seed_mask: jax.Array,  # [N] bool
    *,
    window: int,
    frontier_cap: Optional[int] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Return (scores [N] f32, dist [N] i32). Unreached nodes score 0.

    ``neighbors`` rows hold each node's out+in neighbor ids (-1 = padding).
    """
    N, deg = neighbors.shape
    decay = jnp.asarray(hop_decay_table(max(window, 0)))

    dist = jnp.where(seed_mask, 0, UNREACHED).astype(jnp.int32)

    # The neighbor table is symmetric (both directions inserted), so "any of
    # my neighbors is in the frontier" == "I am a neighbor of the frontier":
    # propagation is a GATHER over each node's own row — no scatter.
    safe_nbrs = jnp.where(neighbors >= 0, neighbors, 0)
    has_nbr = neighbors >= 0

    def dense_hop(h, dist):
        frontier = dist == h - 1
        nbr_in_frontier = jnp.take(frontier, safe_nbrs) & has_nbr
        reach = jnp.any(nbr_in_frontier, axis=1)
        newly = reach & (dist == UNREACHED)
        return jnp.where(newly, h, dist)

    def capped_hop(h, dist):
        frontier_score = jnp.where(dist == h - 1, 1.0, 0.0)
        # top-C frontier nodes (any C frontier nodes — scores are uniform
        # within a hop, so truncation only matters when |frontier| > C)
        _, idx = jax.lax.top_k(frontier_score, frontier_cap)
        is_front = jnp.take(dist, idx) == h - 1
        rows = jnp.take(neighbors, idx, axis=0)  # [C, deg]
        rows = jnp.where(is_front[:, None], rows, -1)
        flat = rows.reshape(-1)
        safe = jnp.where(flat >= 0, flat, N)
        reach = jnp.zeros((N + 1,), dtype=jnp.bool_).at[safe].set(True)[:N]
        newly = reach & (dist == UNREACHED)
        return jnp.where(newly, h, dist)

    hop = capped_hop if frontier_cap else dense_hop
    for h in range(1, max(window, 0) + 1):
        dist = hop(h, dist)

    reached = dist != UNREACHED
    d_clamped = jnp.clip(dist, 0, window if window > 0 else 0)
    scores = jnp.where(reached, jnp.take(decay, d_clamped), 0.0)
    return scores.astype(jnp.float32), dist


@functools.partial(jax.jit, static_argnames=("window", "wave_dtype"))
def expand_frontier_weighted(
    neighbors: jax.Array,  # [N, deg] int32, -1 padded
    seed_scores: jax.Array,  # [N] f32 (0 = not a seed)
    *,
    window: int,
    wave_dtype: str = "float32",
) -> jax.Array:
    """Seed-strength propagation: score[m] = max over seeds s of
    ``seed_scores[s] * decay(d(s, m))`` (d = path length, <= window).

    This is the weighted variant of `expand_frontier` for corpus-scale
    operation where seeds come from a scored candidate pool (e.g. BM25
    top-k) rather than a uniform q_match set: a node reached from a strong
    seed outranks one reached from a weak seed at the same hop distance.
    Uniform seed scores reduce it exactly to `expand_frontier`'s decay(d).

    Each hop is one GATHER-max over the padded adjacency (the table is
    symmetric, so pulling from my neighbors equals pushing to them, with
    no scatter); the running max
    over hops is the result. Revisits are allowed — a strong seed two hops
    away may legitimately beat a weak seed underfoot.
    """
    N, deg = neighbors.shape
    decay = jnp.asarray(hop_decay_table(max(window, 0)))
    safe_nbrs = jnp.where(neighbors >= 0, neighbors, 0)
    has_nbr = neighbors >= 0

    # same wave_dtype contract as `expand_frontier_weighted_batched`:
    # bf16 rounds the wave at identical points across the vmapped,
    # batched, and sharded formulations, so all three agree bit-for-bit
    wdt = jnp.dtype(wave_dtype)
    seeds_f32 = jnp.maximum(seed_scores, 0.0).astype(jnp.float32)
    wave = seeds_f32.astype(wdt)
    best = seeds_f32 * decay[0]
    for h in range(1, max(window, 0) + 1):
        gathered = jnp.where(has_nbr, jnp.take(wave, safe_nbrs),
                             jnp.array(0, wdt))
        wave = jnp.max(gathered, axis=1) if deg else jnp.zeros_like(wave)
        best = jnp.maximum(best, wave.astype(jnp.float32) * decay[h])
    return best


@functools.partial(jax.jit, static_argnames=("window", "frontier_cap"))
def expand_frontier_weighted_capped(
    neighbors: jax.Array,  # [N, deg] int32, -1 padded (symmetric)
    seed_scores: jax.Array,  # [N] f32
    *,
    window: int,
    frontier_cap: int = 256,
) -> jax.Array:
    """`expand_frontier_weighted` with per-hop frontier capping.

    Each hop gathers only the adjacency rows of the top-``frontier_cap``
    wave nodes (O(C*deg) instead of the dense O(N*deg) gather — the dense
    variant moves N*deg*4 bytes per hop, ~14MB/query at N=100k), then
    scatter-maxes their neighbors back into the wave (C*deg elements, tiny).
    Exact whenever the live frontier fits the cap; otherwise the weakest
    frontier nodes don't propagate (they're the least likely to matter).
    """
    N, deg = neighbors.shape
    C = min(frontier_cap, N)
    decay = jnp.asarray(hop_decay_table(max(window, 0)))

    wave = jnp.maximum(seed_scores, 0.0)
    best = wave * decay[0]
    for h in range(1, max(window, 0) + 1):
        top_v, top_i = jax.lax.top_k(wave, C)
        rows = jnp.take(neighbors, top_i, axis=0)  # [C, deg]
        live = (top_v > 0)[:, None] & (rows >= 0)
        flat_dst = jnp.where(live, rows, N).reshape(-1)
        contrib = jnp.broadcast_to(top_v[:, None], (C, deg)).reshape(-1)
        new_wave = (
            jnp.zeros((N + 1,), dtype=jnp.float32)
            .at[flat_dst]
            .max(jnp.where(live.reshape(-1), contrib, 0.0))[:N]
        )
        wave = new_wave
        best = jnp.maximum(best, wave * decay[h])
    return best


@functools.partial(jax.jit, static_argnames=("window", "wave_dtype"))
def expand_frontier_weighted_batched(
    neighbors: jax.Array,   # [N, deg] int32, -1 padded (symmetric)
    seed_scores: jax.Array,  # [B, N] f32
    *,
    window: int,
    wave_dtype: str = "float32",
) -> jax.Array:
    """Batched `expand_frontier_weighted` without the [B, N, deg]
    intermediate.

    The vmapped row-gather formulation materializes a [B, N, deg] f32
    tensor per hop — 27GB at B=2048, N=100k, deg=34, an instant HBM OOM.
    This variant takes one [B, N] gather per neighbor COLUMN (deg is a
    small static constant) and folds the max in place, so peak memory is a
    few [B, N] buffers while the bytes moved stay the same. The
    frontier-capped variant avoids even those bytes but pays a serializing
    scatter-max.
    Semantics identical to `expand_frontier_weighted`.
    """
    N, deg = neighbors.shape
    decay = jnp.asarray(hop_decay_table(max(window, 0)))
    nbrs_t = jnp.swapaxes(neighbors, 0, 1)  # [deg, N]

    # wave_dtype="bfloat16" halves the expansion's HBM traffic (the
    # per-column gathers dominate this op: deg x [B, N] reads per hop);
    # the returned `best` stays f32 and hop-0 keeps FULL seed precision
    # (only the gathered wave is rounded). Opt-in — bf16 rounds hop values
    # (0.7 is not representable), so bit-for-bit oracle parity needs f32.
    wdt = jnp.dtype(wave_dtype)
    seeds_f32 = jnp.maximum(seed_scores, 0.0).astype(jnp.float32)
    wave = seeds_f32.astype(wdt)  # [B, N]
    best = seeds_f32 * decay[0]
    for h in range(1, max(window, 0) + 1):
        # fori_loop (not an unrolled python loop): the unrolled form lets
        # XLA keep all deg gather outputs live at once — 34 x [B, N] f32 =
        # 27GB of HLO temps at B=2048, N=97k. Sequential accumulation
        # bounds live buffers to two [B, N] arrays.
        def body(d, new):
            col = jax.lax.dynamic_index_in_dim(nbrs_t, d, axis=0,
                                               keepdims=False)  # [N]
            g = jnp.take(wave, jnp.where(col >= 0, col, 0), axis=1)
            return jnp.maximum(
                new, jnp.where((col >= 0)[None, :], g, jnp.array(0, wdt)))

        wave = jax.lax.fori_loop(0, deg, body, jnp.zeros_like(wave))
        best = jnp.maximum(best, wave.astype(jnp.float32) * decay[h])
    return best


def _segmax_by_id(ids: jax.Array, vals: jax.Array, n: int):
    """Dedup-max (ids, vals) rows by id with ONE two-key sort.

    Sorting lexicographically by (id asc, -val asc) places each equal-id
    run's maximum at the run START, so no scan is needed at all: the
    per-id max is simply ``vals`` masked to run-start positions. Returns
    ``(sorted_ids, sorted_vals, is_run_start)``; pad entries use id ``n``
    and sort to the end. This is the gather/sort dedup primitive (the same pattern as the
    sorted BM25 phase-1 aggregation); the two-key variadic sort is one
    HLO.
    """
    d, neg_v = jax.lax.sort((ids, -vals), dimension=1, num_keys=2)
    first = jnp.concatenate(
        [jnp.ones_like(d[:, :1], dtype=jnp.bool_), d[:, 1:] != d[:, :-1]],
        axis=1,
    )
    return d, -neg_v, first


@functools.partial(
    jax.jit, static_argnames=("window", "cap", "out_k")
)
def expand_frontier_weighted_compact(
    neighbors: jax.Array,  # [N, deg] int32, -1 padded (symmetric)
    seed_ids: jax.Array,   # [B, S] int32 global rows, -1 padded
    seed_vals: jax.Array,  # [B, S] f32 seed strengths (<=0 = invalid)
    *,
    window: int,
    cap: int = 512,
    out_k: int = 256,
) -> Tuple[jax.Array, jax.Array]:
    """Fully compact `expand_frontier_weighted`: no [B, N] buffer anywhere.

    The wave lives as a compact (ids, vals) pair of width <= ``cap``; each
    hop gathers only the adjacency rows of the current wave ([B, C, deg]
    instead of deg x [B, N] — at N=1M, B=2048 the dense-batched form moves
    ~130GB/hop where this moves ~67MB/hop), dedup-maxes the candidate ids
    by sort + segmented scan, and keeps the strongest ``cap``. The final
    pool is the dedup-max over all hops' (id, val*decay[h]) union, cut to
    ``out_k``. Cost is independent of the corpus size N.

    Truncation contract (same as `expand_frontier_weighted_capped`): only
    the top-``cap`` wave nodes PROPAGATE to the next hop, but every node a
    propagating hop reaches is recorded. Identical to
    `expand_frontier_weighted` whenever each hop's live frontier fits in
    ``cap`` and the reached set fits in ``out_k`` (reference semantics:
    graph_utils.py:58-129 hop-decay BFS, pool-cut to the engine's graph
    pool).

    Returns ``(g_scores [B, out_k] f32, g_ids [B, out_k] int32, -1 padded)``
    sorted by descending score.
    """
    N, _ = neighbors.shape

    def gather_rows(src_ids):
        # [B, C, deg] — gather only the propagating wave's rows
        return jnp.take(neighbors, jnp.clip(src_ids, 0, max(N - 1, 0)), axis=0)

    return expand_frontier_weighted_compact_core(
        gather_rows, seed_ids, seed_vals, n_nodes=N, window=window,
        cap=cap, out_k=out_k)


def expand_frontier_weighted_compact_core(
    gather_rows,
    seed_ids: jax.Array,
    seed_vals: jax.Array,
    *,
    n_nodes: int,
    window: int,
    cap: int,
    out_k: int,
) -> Tuple[jax.Array, jax.Array]:
    """Trace-time core of `expand_frontier_weighted_compact` with a
    pluggable row gather, so the sharded engine can run the IDENTICAL
    compact expansion with its adjacency rows sharded over the mesh
    (``gather_rows(src_ids [B, C]) -> [B, C, deg]`` does an owned-rows
    local gather + a `pmax` all-reduce there). Everything after the gather
    is the same traced computation, so single-chip and sharded agree
    bit-for-bit."""
    N = n_nodes
    B, S = seed_ids.shape
    decay = jnp.asarray(hop_decay_table(max(window, 0)))

    valid0 = (seed_ids >= 0) & (seed_vals > 0)
    wave_ids = jnp.where(valid0, seed_ids, N)
    wave_vals = jnp.where(valid0, seed_vals, 0.0)
    acc_ids = [wave_ids]
    acc_vals = [wave_vals * decay[0]]
    for h in range(1, max(window, 0) + 1):
        # only the top-``cap`` wave nodes propagate (the
        # expand_frontier_weighted_capped contract — the seed wave too)...
        C = min(cap, wave_vals.shape[1])
        src_vals, pos = jax.lax.top_k(wave_vals, C)
        src_ids = jnp.take_along_axis(wave_ids, pos, axis=1)
        rows = gather_rows(src_ids)  # [B, C, deg]
        live = (
            (src_vals > 0)[:, :, None]
            & (src_ids < N)[:, :, None]
            & (rows >= 0)
        )
        cand_ids = jnp.where(live, rows, N).reshape(B, -1)
        cand_vals = jnp.where(
            live, jnp.broadcast_to(src_vals[:, :, None], rows.shape), 0.0
        ).reshape(B, -1)
        d, v, start = _segmax_by_id(cand_ids, cand_vals, N)
        reached = start & (d < N)
        # ...but every node a propagating hop reaches is recorded
        wave_ids = jnp.where(reached, d, N)
        wave_vals = jnp.where(reached, v, 0.0)
        acc_ids.append(wave_ids)
        acc_vals.append(wave_vals * decay[h])

    u_ids = jnp.concatenate(acc_ids, axis=1)
    u_vals = jnp.concatenate(acc_vals, axis=1)
    d, v, start = _segmax_by_id(u_ids, u_vals, N)
    end_vals = jnp.where(start & (d < N), v, 0.0)
    K = min(out_k, end_vals.shape[1])
    g_s, pos = jax.lax.top_k(end_vals, K)
    g_i = jnp.where(g_s > 0, jnp.take_along_axis(d, pos, axis=1), -1)
    return g_s, g_i


def build_neighbor_table(
    n_nodes: int,
    edges_src: np.ndarray,
    edges_dst: np.ndarray,
    max_degree: int,
) -> np.ndarray:
    """Pack an undirected neighbor table [N, max_degree] (-1 padded) from a
    COO edge list; both directions inserted (BFS uses fwd+bwd neighbors,
    reference graph_utils.py:123)."""
    nbrs = np.full((n_nodes, max_degree), -1, dtype=np.int32)
    counts = np.zeros(n_nodes, dtype=np.int32)

    def add(a: int, b: int):
        if counts[a] < max_degree:
            nbrs[a, counts[a]] = b
            counts[a] += 1

    for s, t in zip(edges_src.tolist(), edges_dst.tolist()):
        add(s, t)
        add(t, s)
    return nbrs
