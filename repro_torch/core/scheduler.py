"""Bipartite-graph edge-coloring scheduler (paper §3.3, Listings 1-2).

Per window (set of ``l`` consecutive scheduled rows) we build a bipartite
multigraph: left vertices = window rows (adders), right vertices = lanes
(multipliers, column mod ``l`` after load balancing), one edge per nonzero.
A proper edge coloring — no two edges sharing a vertex get the same color —
is exactly a collision-free schedule: color = time slot, so no multiplier
consumes two elements in one cycle and no adder receives two partial
products in one cycle.

Three colorers are provided:

  * ``method="paper"`` — the exact greedy of Listing 1: per color, iterate
    left vertices in order, each takes its first remaining edge whose lane
    is unused in the current matching.  Pure Python; used for tests and
    small matrices.
  * ``method="fast"``  — vectorized equivalent: per color round, every
    unmatched row *proposes* its first eligible edge; lane conflicts are
    resolved by row priority; losers re-propose until the matching is
    maximal.  Produces a valid coloring with the same greedy-maximal-
    matching structure, at numpy speed across all windows simultaneously.
  * ``method="exact"`` — optimal Δ-coloring (König) via degree-padding +
    Euler-split recursion.  Beyond-paper option (§Perf); guarantees
    C_w == max-degree, the Eq. 1 lower bound.

All three satisfy: validity, completeness, C_w >= Δ_w (Eq. 1 bound).

Counterpart of ``repro.core.scheduler`` (numpy only): every colorer gives
the reference's colors bit for bit, and incremental rescheduling
(:func:`incremental_schedule`) gives a fresh schedule's.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .formats import COOMatrix, GustSchedule
from .load_balance import balance_lanes, balance_rows

__all__ = [
    "schedule",
    "incremental_schedule",
    "window_fingerprints",
    "color_edges_fast",
    "color_edges_paper",
    "color_edges_exact",
    "color_windows_chunked",
    "resolve_workers",
    "sched_counters",
    "reset_sched_counters",
    "DEFAULT_PARALLEL_MIN_EDGES",
]

#: Host-side observability counters.  ``color_calls`` / ``colored_edges``
#: count invocations of any colorer through :func:`schedule` or
#: :func:`incremental_schedule` (two plans over one matrix color once
#: through the ``ScheduleCache``; a ``PlanStore`` warm load colors
#: nothing); ``parallel_chunks`` counts chunks colored by worker
#: processes (0 when the serial colorer ran); ``windows_recolored`` /
#: ``windows_reused`` track incremental rescheduling.
sched_counters: Dict[str, int] = {
    "color_calls": 0,
    "colored_edges": 0,
    "parallel_chunks": 0,
    "windows_recolored": 0,
    "windows_reused": 0,
}


def reset_sched_counters() -> Dict[str, int]:
    """Zero all scheduler counters; returns the (mutable) counter dict."""
    for k in sched_counters:
        sched_counters[k] = 0
    return sched_counters


#: Below this many edges an automatic (``workers=None``) schedule stays
#: serial: process fan-out + shared-memory setup costs ~tens of ms, which
#: only pays off once coloring itself is in the hundreds-of-ms range.
DEFAULT_PARALLEL_MIN_EDGES = 2_000_000

_ENV_WORKERS = "REPRO_SCHED_WORKERS"


def resolve_workers(workers: Optional[int]) -> int:
    """The one decision point for scheduling concurrency: explicit argument,
    else ``REPRO_SCHED_WORKERS``, else ``os.cpu_count()``."""
    if workers is not None:
        return max(int(workers), 1)
    env = os.environ.get(_ENV_WORKERS, "").strip()
    if env:
        try:
            return max(int(env), 1)
        except ValueError:
            pass
    return max(os.cpu_count() or 1, 1)


# ---------------------------------------------------------------------------
# Edge construction
# ---------------------------------------------------------------------------


def _edge_index_dtype(m: int, n: int, nnz: int, l: int) -> np.dtype:
    """Index-dtype policy for the scheduler's edge arrays: int32 whenever
    every value they hold — row/col indices, nnz, and the globalized keys
    ``win*l + local`` (bounded by ceil(m/l)*l + l) — fits, else int64.
    Halves scheduler peak memory on large (but sub-2G) matrices."""
    num_windows = max(-(-m // l), 1)
    key_bound = num_windows * l + l
    if max(m, n, nnz, key_bound) < np.iinfo(np.int32).max:
        return np.dtype(np.int32)
    return np.dtype(np.int64)


def _build_edges(
    coo: COOMatrix, l: int, load_balance: bool
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (win, row_local, lane, col, val, row_perm) sorted by
    (win, row_local, col) — the LIL order Listing 1 consumes.  Integer
    outputs use :func:`_edge_index_dtype` (int32 when everything fits)."""
    m, n = coo.shape
    idx = _edge_index_dtype(m, n, coo.rows.shape[0], l)
    if load_balance:
        row_perm, new_rows = balance_rows(coo)
        new_rows = new_rows.astype(idx, copy=False)
    else:
        row_perm = np.arange(m, dtype=np.int64)
        new_rows = coo.rows.astype(idx)

    win = new_rows // l
    row_local = new_rows - win * l
    if load_balance:
        lane = balance_lanes(win, coo.cols, l, n).astype(idx, copy=False)
    else:
        lane = (coo.cols % l).astype(idx)

    order = np.lexsort((coo.cols, row_local, win))
    return (
        win[order],
        row_local[order],
        lane[order],
        coo.cols[order].astype(idx),
        coo.vals[order],
        row_perm,
    )


# ---------------------------------------------------------------------------
# Colorers
# ---------------------------------------------------------------------------


def color_edges_paper(row_key: np.ndarray, lane_key: np.ndarray) -> np.ndarray:
    """Listing 1, exact semantics.  ``row_key``/``lane_key`` are globally
    unique per window (caller offsets by window).  Edges must be sorted by
    (row_key, intra-row order).  Returns per-edge colors."""
    e = row_key.shape[0]
    colors = np.full(e, -1, dtype=np.int64)
    # Per-row edge lists (indices into the edge arrays).  ``np.unique``
    # returns rows already ascending, so iterating this list *is* the
    # paper's in-order left-vertex sweep — a ``done`` mask replaces the
    # old per-round ``sorted(dict)`` rebuild (O(rows log rows) per color).
    rows, row_starts = np.unique(row_key, return_index=True)
    bounds = np.append(row_starts, e)
    row_edges = [list(range(bounds[i], bounds[i + 1])) for i in range(rows.shape[0])]
    done = [False] * rows.shape[0]
    remaining = rows.shape[0]
    clr = 0
    while remaining:
        matching = set()
        for i in range(rows.shape[0]):  # iterate left vertices in order
            if done[i]:
                continue
            edges = row_edges[i]
            for pos, eidx in enumerate(edges):
                lk = int(lane_key[eidx])
                if lk not in matching:
                    colors[eidx] = clr
                    matching.add(lk)
                    edges.pop(pos)
                    break  # paper's break: one edge per row per color
            if not edges:
                done[i] = True
                remaining -= 1
        clr += 1
    return colors


def color_edges_fast(row_key: np.ndarray, lane_key: np.ndarray) -> np.ndarray:
    """Vectorized greedy maximal-matching coloring (see module docstring).
    Edges must be sorted by (row_key, intra-row order); keys globally
    unique per window.

    The proposal loop is O(e) per round: candidate indices stay ascending,
    so ``row_key[elig]`` is a sequence of runs and the first edge of each
    run is that row's first eligible edge — a boundary scan replaces the
    old ``np.unique(..., return_index=True)`` sort.  Lane-conflict
    resolution uses an indexed scatter (last write wins on the reversed
    position array == smallest proposal index per lane), which picks the
    same lowest-row winner the old first-occurrence rule picked."""
    e = row_key.shape[0]
    colors = np.full(e, -1, dtype=np.int64)
    if e == 0:
        return colors
    n_rows = int(row_key.max()) + 1
    n_lanes = int(lane_key.max()) + 1
    alive_idx = np.arange(e, dtype=np.int64)  # sorted by (row, order)
    lane_min_pos = np.empty(n_lanes, dtype=np.int64)  # scratch, per proposal round
    clr = 0
    while alive_idx.size:
        lane_busy = np.zeros(n_lanes, dtype=bool)
        row_done = np.zeros(n_rows, dtype=bool)
        cand = alive_idx
        while cand.size:
            elig = cand[~row_done[row_key[cand]] & ~lane_busy[lane_key[cand]]]
            if elig.size == 0:
                break
            # First eligible edge per row: elig is ascending, edges are
            # row-order sorted, so run starts in row_key[elig] are exactly
            # the first eligible edge per row.
            rk = row_key[elig]
            head = np.empty(elig.size, dtype=bool)
            head[0] = True
            np.not_equal(rk[1:], rk[:-1], out=head[1:])
            proposals = elig[head]
            # Lane conflicts: lower row wins (proposals are row-ascending).
            # Writing positions in reverse makes the *smallest* position
            # per lane the surviving write.
            lk = lane_key[proposals]
            pos = np.arange(proposals.size, dtype=np.int64)
            lane_min_pos[lk[::-1]] = pos[::-1]
            winners = proposals[lane_min_pos[lk] == pos]
            colors[winners] = clr
            lane_busy[lane_key[winners]] = True
            row_done[row_key[winners]] = True
            if winners.size == proposals.size:
                # every proposing row matched; remaining rows had no
                # eligible edge at proposal time -> re-scan survivors once
                cand = elig if elig.size > winners.size else np.empty(0, np.int64)
            else:
                cand = elig  # losers re-propose against updated busy sets
        alive_idx = alive_idx[colors[alive_idx] < 0]
        clr += 1
    return colors


def _euler_split(row_key: np.ndarray, lane_key: np.ndarray) -> np.ndarray:
    """Split a bipartite multigraph with all even degrees into two halves of
    equal degree by 2-coloring edges along Eulerian circuits.  Returns a
    0/1 label per edge."""
    e = row_key.shape[0]
    label = np.empty(e, dtype=np.int8)
    # adjacency: node -> list of (edge, other)  (bipartite: offset lanes)
    n_rows = int(row_key.max()) + 1 if e else 0
    lanes_off = lane_key + n_rows
    n_nodes = int(lanes_off.max()) + 1 if e else 0
    adj_head = np.full(n_nodes, -1, dtype=np.int64)
    nxt = np.empty(2 * e, dtype=np.int64)
    ends = np.empty(2 * e, dtype=np.int64)  # node at the far end of half-edge
    eid = np.empty(2 * e, dtype=np.int64)
    for k in range(e):  # build linked adjacency (both directions)
        for half, (a, b) in enumerate(((row_key[k], lanes_off[k]), (lanes_off[k], row_key[k]))):
            h = 2 * k + half
            nxt[h] = adj_head[a]
            adj_head[a] = h
            ends[h] = b
            eid[h] = k
    used = np.zeros(e, dtype=bool)
    for start in range(n_nodes):
        while adj_head[start] != -1 and used[eid[adj_head[start]]]:
            adj_head[start] = nxt[adj_head[start]]
        if adj_head[start] == -1:
            continue
        node, parity = start, 0
        while True:
            h = adj_head[node]
            while h != -1 and used[eid[h]]:
                h = nxt[h]
            adj_head[node] = h
            if h == -1:
                break
            k = eid[h]
            used[k] = True
            label[k] = parity
            parity ^= 1
            node = ends[h]
    return label


def _perfect_matching_regular(
    row_key: np.ndarray, lane_key: np.ndarray, n: int
) -> np.ndarray:
    """Perfect matching of a d-regular bipartite multigraph with ``n`` nodes
    per side (exists by Hall's theorem).  Hopcroft-Karp.  Returns the edge
    index matched to each left node, shape (n,)."""
    order = np.argsort(row_key, kind="stable")
    starts = np.searchsorted(row_key[order], np.arange(n + 1))
    INF = 1 << 60
    match_l = np.full(n, -1, dtype=np.int64)  # left  -> edge idx
    match_r = np.full(n, -1, dtype=np.int64)  # right -> left node
    while True:
        # BFS layers over free left nodes.
        dist = np.full(n, INF, dtype=np.int64)
        queue = [u for u in range(n) if match_l[u] == -1]
        for u in queue:
            dist[u] = 0
        found = False
        qi = 0
        while qi < len(queue):
            u = queue[qi]
            qi += 1
            for ei in order[starts[u] : starts[u + 1]]:
                w = match_r[lane_key[ei]]
                if w == -1:
                    found = True
                elif dist[w] == INF:
                    dist[w] = dist[u] + 1
                    queue.append(w)
        if not found:
            break

        def dfs(u: int) -> bool:
            for ei in order[starts[u] : starts[u + 1]]:
                v = lane_key[ei]
                w = match_r[v]
                if w == -1 or (dist[w] == dist[u] + 1 and dfs(w)):
                    match_l[u] = ei
                    match_r[v] = u
                    return True
            dist[u] = INF
            return False

        for u in range(n):
            if match_l[u] == -1:
                dfs(u)
    if (match_l < 0).any():
        raise AssertionError("regular bipartite graph must have a perfect matching")
    return match_l


def color_edges_exact(row_key: np.ndarray, lane_key: np.ndarray) -> np.ndarray:
    """Optimal Δ-edge-coloring of the bipartite multigraph (König theorem:
    chromatic index of a bipartite multigraph equals its max degree Δ).

    Classical scheme: Δ-regularize with dummy edges, then peel — if the
    current regular degree d is odd, extract a perfect matching (one color)
    and recurse on d-1; if even, Euler-split into two d/2-regular halves.
    Real edges receive exactly Δ colors."""
    e = row_key.shape[0]
    if e == 0:
        return np.empty(0, dtype=np.int64)
    n_rows = int(row_key.max()) + 1
    n_lanes = int(lane_key.max()) + 1
    n = max(n_rows, n_lanes)
    deg_r = np.bincount(row_key, minlength=n)
    deg_l = np.bincount(lane_key, minlength=n)
    delta = int(max(deg_r.max(), deg_l.max()))
    # Δ-regularize: both sides have n nodes, so stub counts match exactly.
    pad_r = np.repeat(np.arange(n, dtype=np.int64), delta - deg_r)
    pad_l = np.repeat(np.arange(n, dtype=np.int64), delta - deg_l)
    assert pad_r.size == pad_l.size == n * delta - e
    rk = np.concatenate([row_key.astype(np.int64), pad_r])
    lk = np.concatenate([lane_key.astype(np.int64), pad_l])
    total = rk.shape[0]
    colors = np.full(total, -1, dtype=np.int64)
    next_color = [0]

    def rec(idx: np.ndarray, d: int):
        if idx.size == 0 or d == 0:
            return
        if d == 1:
            colors[idx] = next_color[0]
            next_color[0] += 1
            return
        if d % 2 == 1:
            sub_match = _perfect_matching_regular(rk[idx], lk[idx], n)
            colors[idx[sub_match]] = next_color[0]
            next_color[0] += 1
            keep = np.ones(idx.size, dtype=bool)
            keep[sub_match] = False
            rec(idx[keep], d - 1)
        else:
            lab = _euler_split(rk[idx], lk[idx])
            rec(idx[lab == 0], d // 2)
            rec(idx[lab == 1], d // 2)

    rec(np.arange(total, dtype=np.int64), delta)
    out = colors[:e]
    assert out.min() >= 0 and out.max() < delta
    return out


_COLORERS = {
    "paper": color_edges_paper,
    "fast": color_edges_fast,
    "exact": color_edges_exact,
}


# ---------------------------------------------------------------------------
# Parallel window-chunked coloring
# ---------------------------------------------------------------------------
#
# Windows are independent coloring problems: globalized keys (win*l + local)
# never collide across windows, and every window's edges receive colors
# 0..C_w-1 regardless of what other windows contain.  Coloring a contiguous
# run of whole windows in one process therefore produces *bit-identical*
# colors to the serial pass — chunk boundaries only have to land on window
# boundaries.  Workers attach a shared int64 buffer holding
# (row_key, lane_key, colors-out), so the only per-chunk IPC is five ints.


def _chunk_bounds(
    win: np.ndarray, num_windows: int, n_chunks: int
) -> Sequence[Tuple[int, int, int]]:
    """Split the edge stream into <= ``n_chunks`` contiguous, window-aligned
    ranges with roughly equal edge counts.  Returns (start, stop, first_win)
    edge-index triples; empty ranges are dropped."""
    e = win.shape[0]
    # Edge offset of each window boundary.
    w_off = np.searchsorted(win, np.arange(num_windows + 1))
    targets = (np.arange(1, n_chunks) * e) // n_chunks
    cut_wins = np.unique(
        np.concatenate(
            [[0], np.searchsorted(w_off, targets, side="left"), [num_windows]]
        )
    )
    cut_wins = cut_wins[cut_wins <= num_windows]
    bounds = []
    for i in range(cut_wins.shape[0] - 1):
        s, t = int(w_off[cut_wins[i]]), int(w_off[cut_wins[i + 1]])
        if t > s:
            bounds.append((s, t, int(cut_wins[i])))
    return bounds


def _color_chunk_worker(shm_name: str, e: int, s: int, t: int, base: int) -> int:
    """Color edges [s, t) of the shared (3, e) buffer in place.  ``base``
    re-localizes the globalized keys so scratch arrays are chunk-sized."""
    from multiprocessing import shared_memory

    shm = shared_memory.SharedMemory(name=shm_name)
    try:
        buf = np.ndarray((3, e), dtype=np.int64, buffer=shm.buf)
        buf[2, s:t] = color_edges_fast(buf[0, s:t] - base, buf[1, s:t] - base)
    finally:
        shm.close()
    return s


def color_windows_chunked(
    row_key: np.ndarray,
    lane_key: np.ndarray,
    win: np.ndarray,
    num_windows: int,
    l: int,
    *,
    workers: Optional[int] = None,
    min_edges: Optional[int] = None,
) -> np.ndarray:
    """Fast coloring with window-chunked process parallelism.

    Bit-identical to ``color_edges_fast(row_key, lane_key)`` by window
    independence (see section comment).  Runs the serial colorer when
    parallelism can't help (one worker, too few edges or windows) or
    can't run (no fork start method) — an explicit ``workers >= 2`` skips
    the ``min_edges`` threshold so small inputs can exercise the parallel
    path deterministically."""
    e = row_key.shape[0]
    n_workers = resolve_workers(workers)
    if min_edges is None:
        min_edges = DEFAULT_PARALLEL_MIN_EDGES if workers is None else 0
    if n_workers < 2 or e == 0 or e < min_edges or num_windows < 2:
        return color_edges_fast(row_key, lane_key)

    import multiprocessing as mp

    if "fork" not in mp.get_all_start_methods():
        # spawn would re-import the caller's __main__; not worth the risk
        # for a pure perf path — the serial colorer is always correct.
        return color_edges_fast(row_key, lane_key)

    chunks = _chunk_bounds(win, num_windows, n_chunks=n_workers)
    if len(chunks) < 2:
        return color_edges_fast(row_key, lane_key)

    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import shared_memory

    # The children run numpy only (no torch, no CUDA), so forking a parent
    # that has already initialized CUDA is safe.
    shm = shared_memory.SharedMemory(create=True, size=3 * e * 8)
    try:
        buf = np.ndarray((3, e), dtype=np.int64, buffer=shm.buf)
        np.copyto(buf[0], row_key, casting="safe")
        np.copyto(buf[1], lane_key, casting="safe")
        ctx = mp.get_context("fork")
        with ProcessPoolExecutor(max_workers=len(chunks), mp_context=ctx) as pool:
            futures = [
                pool.submit(_color_chunk_worker, shm.name, e, s, t, base * l)
                for (s, t, base) in chunks
            ]
            for f in futures:
                f.result()
        colors = buf[2].copy()
        sched_counters["parallel_chunks"] += len(chunks)
        return colors
    finally:
        shm.close()
        shm.unlink()


def _color_edges(
    method: str,
    win: np.ndarray,
    row_local: np.ndarray,
    lane: np.ndarray,
    num_windows: int,
    l: int,
    workers: Optional[int],
) -> np.ndarray:
    """Dispatch to the requested colorer over an edge stream sorted by
    (win, row_local, col); counts the call in :data:`sched_counters`."""
    e = win.shape[0]
    sched_counters["color_calls"] += 1
    sched_counters["colored_edges"] += int(e)
    if method == "exact":
        # Per-window exact coloring (windows are independent graphs).
        colors = np.empty(e, dtype=np.int64)
        w_ids, w_starts = np.unique(win, return_index=True)
        bounds = np.append(w_starts, e)
        for i in range(w_ids.shape[0]):
            s, t = bounds[i], bounds[i + 1]
            colors[s:t] = color_edges_exact(row_local[s:t], lane[s:t])
        return colors
    # Globalized keys let one pass color every window at once (the index
    # dtype policy guarantees win*l + local fits the edge dtype).
    row_key = win * l + row_local
    lane_key = win * l + lane
    if method == "fast":
        return color_windows_chunked(
            row_key, lane_key, win, num_windows, l, workers=workers
        )
    return _COLORERS[method](row_key, lane_key)


# ---------------------------------------------------------------------------
# Full scheduling pipeline (Listing 1 + Listing 2)
# ---------------------------------------------------------------------------


def _alloc_tables(c_total: int, l: int, value_dtype):
    """Listing 2 output tables, padding-initialized: value 0, row 0, and
    col == lane.  Padding slots gather v[lane] and multiply by 0 — always
    safe: the executor zero-pads x to ceil(n/l)*l rows, and col==lane
    preserves the lane structure the reference's fused gather needs."""
    rows = max(c_total, 1)
    m_sch = np.zeros((rows, l), dtype=value_dtype)
    row_sch = np.zeros((rows, l), dtype=np.int32)
    col_sch = np.tile(np.arange(l, dtype=np.int32), (rows, 1))
    valid = np.zeros((rows, l), dtype=bool)
    return m_sch, row_sch, col_sch, valid


def schedule(
    coo: COOMatrix,
    l: int,
    *,
    load_balance: bool = True,
    method: str = "fast",
    value_dtype=np.float32,
    workers: Optional[int] = None,
) -> GustSchedule:
    """Preprocess a sparse matrix into the GUST scheduled format.

    ``workers`` controls window-chunked parallel coloring for
    ``method="fast"`` (None = auto: ``REPRO_SCHED_WORKERS`` else cpu count,
    applied only above :data:`DEFAULT_PARALLEL_MIN_EDGES` edges).  The
    schedule is bit-identical for every worker count, so ``workers`` is
    *not* part of any cache or store key."""
    if method not in _COLORERS:
        raise ValueError(f"unknown coloring method {method!r}")
    m, n = coo.shape
    num_windows = max(-(-m // l), 1)

    win, row_local, lane, col, val, row_perm = _build_edges(coo, l, load_balance)
    e = win.shape[0]

    if e:
        colors = _color_edges(method, win, row_local, lane, num_windows, l, workers)
    else:
        colors = np.empty(0, dtype=np.int64)

    # Colors per window -> global cycle offsets.
    colors_per_window = np.zeros(num_windows, dtype=np.int64)
    if e:
        np.maximum.at(colors_per_window, win, colors + 1)
    window_starts = np.zeros(num_windows + 1, dtype=np.int64)
    np.cumsum(colors_per_window, out=window_starts[1:])
    c_total = int(window_starts[-1])

    # Listing 2: materialize M_sch / Row_sch / Col_sch.
    m_sch, row_sch, col_sch, valid = _alloc_tables(c_total, l, value_dtype)
    if e:
        gcycle = window_starts[win] + colors
        if valid[gcycle, lane].any() or np.unique(gcycle * l + lane).size != e:
            raise AssertionError("collision in schedule — invalid coloring")
        m_sch[gcycle, lane] = val.astype(value_dtype)
        row_sch[gcycle, lane] = row_local.astype(np.int32)
        col_sch[gcycle, lane] = col.astype(np.int32)
        valid[gcycle, lane] = True

    return GustSchedule(
        l=l,
        shape=(m, n),
        nnz=e,
        m_sch=m_sch,
        row_sch=row_sch,
        col_sch=col_sch,
        window_starts=window_starts,
        row_perm=row_perm,
        valid=valid,
    )


# ---------------------------------------------------------------------------
# Incremental re-scheduling (dirty-window re-coloring)
# ---------------------------------------------------------------------------


def _window_hashes(
    win: np.ndarray,
    row_local: np.ndarray,
    col: np.ndarray,
    val: np.ndarray,
    num_windows: int,
) -> np.ndarray:
    """sha1 fingerprint of each window's edge content.  Hashed over
    canonical dtypes (int64 indices, float64 values) so the fingerprint is
    independent of the edge-array index-dtype policy."""
    e = win.shape[0]
    bounds = np.searchsorted(win, np.arange(num_windows + 1))
    rl64 = np.ascontiguousarray(row_local, dtype=np.int64)
    c64 = np.ascontiguousarray(col, dtype=np.int64)
    v64 = np.ascontiguousarray(val, dtype=np.float64)
    out = np.empty(num_windows, dtype="S20")
    for w in range(num_windows):
        s, t = int(bounds[w]), int(bounds[w + 1])
        h = hashlib.sha1()
        h.update(rl64[s:t].tobytes())
        h.update(c64[s:t].tobytes())
        h.update(v64[s:t].tobytes())
        out[w] = h.digest()
    return out


def window_fingerprints(coo: COOMatrix, l: int) -> np.ndarray:
    """Per-window content fingerprints under the ``load_balance=False``
    window assignment (win = row // l) — the diff key for
    :func:`incremental_schedule`."""
    win, row_local, _, col, val, _ = _build_edges(coo, l, False)
    num_windows = max(-(-coo.shape[0] // l), 1)
    return _window_hashes(win, row_local, col, val, num_windows)


def _ranges(starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Concatenation of arange(start, start+length) per pair — vectorized
    multi-slice index construction."""
    lengths = np.asarray(lengths, dtype=np.int64)
    total = int(lengths.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    out = np.repeat(np.asarray(starts, dtype=np.int64), lengths)
    resets = np.repeat(np.cumsum(lengths) - lengths, lengths)
    return out + (np.arange(total, dtype=np.int64) - resets)


def incremental_schedule(
    old_sched: GustSchedule,
    new_coo: COOMatrix,
    *,
    old_coo: Optional[COOMatrix] = None,
    old_hashes: Optional[np.ndarray] = None,
    method: str = "fast",
    workers: Optional[int] = None,
) -> Tuple[GustSchedule, np.ndarray, np.ndarray]:
    """Re-schedule ``new_coo`` reusing ``old_sched`` wherever possible.

    Diffs per-window content fingerprints, recolors only the dirty
    windows, and splices their cycles into a fresh global table; clean
    windows' schedule rows are copied verbatim.  Because windows are
    independent coloring problems, the result is **bit-identical** to a
    fresh ``schedule(new_coo, l, load_balance=False, method=...)``.

    Only valid for ``load_balance=False`` schedules: row balancing is a
    global function of the whole matrix, so any content change could
    reassign every window.  ``old_sched.row_perm`` must be the identity.

    Returns ``(new_sched, dirty_windows, new_hashes)``; pass ``new_hashes``
    back as ``old_hashes`` on the next delta to skip re-hashing the old
    side.  Counts windows in ``sched_counters`` (windows_recolored /
    windows_reused)."""
    if method not in _COLORERS:
        raise ValueError(f"unknown coloring method {method!r}")
    l = old_sched.l
    m, n = old_sched.shape
    if tuple(new_coo.shape) != (m, n):
        raise ValueError(
            f"incremental_schedule: shape changed {old_sched.shape} -> "
            f"{tuple(new_coo.shape)}; build a fresh plan instead"
        )
    if not np.array_equal(old_sched.row_perm, np.arange(m)):
        raise ValueError(
            "incremental_schedule requires a load_balance=False schedule "
            "(row_perm must be identity)"
        )
    num_windows = old_sched.num_windows

    win, row_local, lane, col, val, row_perm = _build_edges(new_coo, l, False)
    e = win.shape[0]
    new_hashes = _window_hashes(win, row_local, col, val, num_windows)
    if old_hashes is None:
        if old_coo is None:
            raise ValueError("incremental_schedule needs old_coo or old_hashes")
        old_hashes = window_fingerprints(old_coo, l)
    old_hashes = np.asarray(old_hashes)
    if old_hashes.shape != new_hashes.shape:
        raise ValueError("old_hashes has wrong window count")

    dirty_mask = old_hashes != new_hashes
    dirty = np.nonzero(dirty_mask)[0]
    clean = np.nonzero(~dirty_mask)[0]
    sched_counters["windows_recolored"] += int(dirty.size)
    sched_counters["windows_reused"] += int(clean.size)

    # --- recolor dirty windows only -------------------------------------
    edge_dirty = dirty_mask[win]
    d_idx = np.nonzero(edge_dirty)[0]
    cpw_old = np.diff(old_sched.window_starts)
    cpw_new = cpw_old.copy()
    cpw_new[dirty] = 0  # dirty windows that became empty stay at 0 colors
    if d_idx.size:
        colors_d = _color_edges(
            method,
            win[d_idx],
            row_local[d_idx],
            lane[d_idx],
            num_windows,
            l,
            workers,
        )
        np.maximum.at(cpw_new, win[d_idx], colors_d + 1)

    window_starts = np.zeros(num_windows + 1, dtype=np.int64)
    np.cumsum(cpw_new, out=window_starts[1:])
    c_total = int(window_starts[-1])

    # --- splice: copy clean windows' rows, scatter dirty edges ----------
    m_sch, row_sch, col_sch, valid = _alloc_tables(c_total, l, old_sched.m_sch.dtype)
    if clean.size:
        src = _ranges(old_sched.window_starts[clean], cpw_old[clean])
        dst = _ranges(window_starts[clean], cpw_old[clean])
        m_sch[dst] = old_sched.m_sch[src]
        row_sch[dst] = old_sched.row_sch[src]
        col_sch[dst] = old_sched.col_sch[src]
        valid[dst] = old_sched.valid[src]
    if d_idx.size:
        lane_d = lane[d_idx]
        gcycle = window_starts[win[d_idx]] + colors_d
        if valid[gcycle, lane_d].any() or np.unique(gcycle * l + lane_d).size != d_idx.size:
            raise AssertionError("collision in incremental schedule")
        m_sch[gcycle, lane_d] = val[d_idx].astype(old_sched.m_sch.dtype)
        row_sch[gcycle, lane_d] = row_local[d_idx].astype(np.int32)
        col_sch[gcycle, lane_d] = col[d_idx].astype(np.int32)
        valid[gcycle, lane_d] = True

    new_sched = GustSchedule(
        l=l,
        shape=(m, n),
        nnz=e,
        m_sch=m_sch,
        row_sch=row_sch,
        col_sch=col_sch,
        window_starts=window_starts,
        row_perm=row_perm,
        valid=valid,
    )
    return new_sched, dirty, new_hashes
