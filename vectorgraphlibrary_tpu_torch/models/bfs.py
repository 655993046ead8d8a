"""BFS: top-down, bottom-up, direction-optimizing and bit-parallel
multi-source (port of vectorgraphlibrary_tpu/models/bfs.py).

Capability match for the reference BFS (`algorithms/bfs/bfs.hpp:5-86`
top-down; `bfs/hardwired_do_bfs.hpp` direction-optimizing state machine).
Levels follow the reference: source level = FIRST_LEVEL = 1, unvisited = -1
(`bfs/change_state/change_state.h:21-23`).

- A top-down step is the sparse push from the compacted frontier,
  min-combining the constant next level (`advance_push_sparse_const`): one
  expand-and-scatter kernel launch on the card.
- A bottom-up step is the dense pull over incoming edges asking "is any
  in-neighbour on the current level?" (a bool `or` pull: one CSR pull kernel
  launch, plus vertex routes where the levels are in the other ordering).
- The direction choice uses Beamer's thresholds on frontier neighbour counts
  (the analog of `hardwired_do_bfs.hpp:925-990`).

The reference runs the device DO-BFS and MS-BFS level loops inside one
compiled program (`lax.while_loop`, `lax.switch`); here they are host loops
that read each level's scalars back in one transfer and pick the same branch
by the same test, so the levels and the branch sequence match the reference.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import TraversalDirection
from ..graph.device import VGLGraph
from ..graph.frontier import Frontier, compact_ids
from ..graph.vertices import VertexArray
from ..ops.advance import advance_pull_value, advance_push_sparse_const
from . import common

S, G = TraversalDirection.SCATTER, TraversalDirection.GATHER
UNVISITED = -1
FIRST_LEVEL = 1
_INF32 = torch.iinfo(torch.int32).max
_F32 = np.float32


def _levels_from(graph: VGLGraph, sid) -> torch.Tensor:
    levels = torch.full((graph.v_pad,), _INF32, dtype=torch.int32,
                        device=graph.device)
    levels[sid] = FIRST_LEVEL
    return levels


def _push(graph: VGLGraph, levels_s: torch.Tensor, ids, valid, ecap: int,
          cur: int) -> torch.Tensor:
    """Levels after one top-down push from the compacted frontier (ids,
    valid) in SCATTER ordering: every out-neighbour takes min(level, cur + 1).
    Unvisited is INF, so the min-combine is monotone."""
    return advance_push_sparse_const(graph, ids, valid, ecap, cur + 1, "min",
                                     levels_s, direction=S)


def _counts(newly: torch.Tensor, degrees: torch.Tensor):
    """(size, nbrs) of a new frontier, as int32 0-d tensors on the device."""
    size = torch.sum(newly, dtype=torch.int32)
    nbrs = torch.sum(torch.where(newly, degrees, 0), dtype=torch.int32)
    return size, nbrs


def _td_step(graph: VGLGraph, levels_inf, ids, valid, ecap: int,
             current_level: int):
    """One top-down step in SCATTER ordering."""
    out = _push(graph, levels_inf, ids, valid, ecap, current_level)
    new_mask = out < levels_inf
    size, nbrs = _counts(new_mask, graph.outgoing.degrees)
    return out, new_mask, size, nbrs


def _bu_step(graph: VGLGraph, levels_g, outdeg_g, current_level: int):
    """One bottom-up step in GATHER ordering: unvisited vertices look for any
    in-neighbour on the current level."""
    on_level = levels_g == current_level
    reached = advance_pull_value(graph, on_level, "or", direction=G)
    newly = (levels_g == _INF32) & reached
    levels_new = torch.where(newly, current_level + 1, levels_g)
    size, nbrs = _counts(newly, outdeg_g)
    return levels_new, newly, size, nbrs


def _finish(levels: torch.Tensor) -> torch.Tensor:
    return torch.where(levels == _INF32, UNVISITED, levels)


def vgl_top_down(graph: VGLGraph, source_vertex: int,
                 max_capacity: int = 1 << 20) -> VertexArray:
    """Pure top-down BFS (reference vgl_top_down). Capacities follow each
    level's frontier: the next power of two of its size and its degree sum
    (`max_capacity` is accepted as in the reference and not used)."""
    v_pad = graph.v_pad
    dev = graph.device
    sid = int(graph.outgoing.orig_to_sorted[source_vertex])
    levels = _levels_from(graph, sid)
    mask = torch.zeros(v_pad, dtype=torch.bool, device=dev)
    mask[sid] = True
    size = 1
    nbrs = int(graph.outgoing.degrees[sid])
    current = FIRST_LEVEL
    while size > 0:
        cap = min(common.next_pow2(max(size, 8)), v_pad)
        ecap = min(common.next_pow2(max(nbrs, 8)), max(graph.e, 8))
        fr = Frontier(mask=mask, size=torch.tensor(size, dtype=torch.int32,
                                                   device=dev),
                      neighbours_count=torch.tensor(nbrs, dtype=torch.int32,
                                                    device=dev), direction=S)
        ids, valid = compact_ids(fr, cap)
        levels, mask, dsize, dnbrs = _td_step(graph, levels, ids, valid, ecap,
                                              current)
        size, nbrs = common.read_scalars(dsize, dnbrs)
        current += 1
    return VertexArray(values=_finish(levels), direction=S)


def vgl_bfs(graph: VGLGraph, source_vertex: int, alpha: float = 15.0,
            beta: float = 18.0) -> VertexArray:
    """Direction-optimizing BFS (reference hardwired_do_bfs analog).

    Runs top-down on small frontiers, switches to the bottom-up pull when the
    frontier's out-edge count exceeds |E_unexplored|/alpha, and back when the
    frontier shrinks below |V|/beta (Beamer's heuristic)."""
    v, e, v_pad = graph.v, graph.e, graph.v_pad
    dev = graph.device
    sid = int(graph.outgoing.orig_to_sorted[source_vertex])
    levels = _levels_from(graph, sid)
    mask = torch.zeros(v_pad, dtype=torch.bool, device=dev)
    mask[sid] = True
    size = 1
    nbrs = int(graph.outgoing.degrees[sid])
    current = FIRST_LEVEL
    state = "td"       # levels/mask ordering: td -> SCATTER, bu -> GATHER
    unexplored_edges = e
    outdeg_g = common.outdegrees_in(graph, G)

    while size > 0:
        if state == "td" and nbrs > unexplored_edges / alpha and size > 16:
            levels = common.to_direction(graph, levels, S, G)
            state = "bu"
        elif state == "bu" and size < v / beta:
            levels = common.to_direction(graph, levels, G, S)
            mask = levels == current   # frontier mask in the new ordering
            state = "td"

        if state == "td":
            cap = min(common.next_pow2(max(size, 8)), v_pad)
            ecap = min(common.next_pow2(max(nbrs, 8)), max(e, 8))
            fr = Frontier(mask=mask,
                          size=torch.tensor(size, dtype=torch.int32, device=dev),
                          neighbours_count=torch.tensor(nbrs, dtype=torch.int32,
                                                        device=dev),
                          direction=S)
            ids, valid = compact_ids(fr, cap)
            levels, mask, dsize, dnbrs = _td_step(graph, levels, ids, valid,
                                                  ecap, current)
        else:
            levels, mask, dsize, dnbrs = _bu_step(graph, levels, outdeg_g,
                                                  current)
        size, nbrs = common.read_scalars(dsize, dnbrs)
        unexplored_edges = max(unexplored_edges - nbrs, 0)
        current += 1

    if state == "bu":
        levels = common.to_direction(graph, levels, G, S)
    return VertexArray(values=_finish(levels), direction=S)


def _do_bfs_levels(graph: VGLGraph, source_sorted_s: torch.Tensor,
                   id_cap: int, edge_cap: int, alpha: float, beta: float,
                   trace: Optional[list] = None) -> torch.Tensor:
    """Direction-optimizing BFS with its state on the device (reference
    bfs.py:143-241): levels live in SCATTER ordering; each level takes the
    smallest sparse-push tier that fits the frontier when Beamer's test
    allows top-down, else the dense bottom-up pull, which consumes the
    S-ordered frontier directly (src_in_src_order) and pays one vertex route
    for its G-ordered output. The host reads (size, nbrs) once per level.

    trace: if a list, each level appends ("td", id_cap, edge_cap) or
    ("bu",) for the branch it took."""
    v, e = graph.v, graph.e
    outdeg_s = graph.outgoing.degrees
    tiers = common.capacity_tiers(id_cap, edge_cap)

    zero = torch.zeros((), dtype=torch.int32, device=graph.device)
    levels = _levels_from(graph, source_sorted_s)
    size, nbrs = 1, int(outdeg_s[source_sorted_s])
    cur, unexplored = FIRST_LEVEL, e
    while size > 0:
        # Beamer's two-sided test, in f32 as the reference computes it:
        # top-down while the frontier's out-edges are few against the
        # unexplored edges, or once the frontier is below v / beta
        td_ok = ((_F32(nbrs) < _F32(unexplored) / _F32(alpha))
                 or (_F32(size) * _F32(beta) < _F32(v)))
        tier = next((t for t in tiers
                     if td_ok and size < t[0] and nbrs < t[1]), None)
        if tier is not None:
            mask_s = levels == cur
            fr = Frontier(mask=mask_s, size=torch.sum(mask_s, dtype=torch.int32),
                          neighbours_count=zero, direction=S)
            ids, valid = compact_ids(fr, tier[0])
            newly = _push(graph, levels, ids, valid, tier[1], cur) < levels
        else:
            on_s = levels == cur
            reached_g = advance_pull_value(graph, on_s, "or", direction=G,
                                           src_in_src_order=True)
            reached_s = common.to_direction(graph, reached_g, G, S)
            newly = (levels == _INF32) & reached_s
        if trace is not None:
            trace.append(("td",) + tier if tier is not None else ("bu",))
        levels = torch.where(newly, cur + 1, levels)
        size, nbrs = common.read_scalars(*_counts(newly, outdeg_s))
        cur += 1
        unexplored = max(unexplored - nbrs, 0)
    return _finish(levels)


def vgl_bfs_device(graph: VGLGraph, source_vertex: int, alpha: float = 15.0,
                   beta: float = 18.0, id_cap: int = 1 << 12,
                   edge_cap: int = 1 << 16,
                   trace: Optional[list] = None) -> VertexArray:
    """Direction-optimizing BFS with device-resident state (reference
    vgl_bfs_device); `trace` as in _do_bfs_levels."""
    sid = graph.outgoing.orig_to_sorted[source_vertex].long()
    ec2 = min(common.next_pow2(max(graph.e, 8)), edge_cap)
    levels = _do_bfs_levels(graph, sid, min(id_cap, graph.v_pad), ec2, alpha,
                            beta, trace)
    return VertexArray(values=levels, direction=S)


def vgl_bfs_device_multi(graph: VGLGraph, source_vertices, alpha: float = 15.0,
                         beta: float = 18.0, id_cap: int = 1 << 12,
                         edge_cap: int = 1 << 16) -> VertexArray:
    """k DO-BFS traversals one after another (the graph500 multi-root
    protocol): levels [k, v_pad] in SCATTER ordering."""
    return VertexArray(values=torch.stack([
        vgl_bfs_device(graph, s, alpha, beta, id_cap, edge_cap).values
        for s in source_vertices]), direction=S)


def _msbfs_word(graph: VGLGraph, roots_sorted_s: torch.Tensor,
                max_levels: int) -> torch.Tensor:
    """Bit-parallel multi-source BFS over ONE int32 word (reference
    bfs.py:285-326): up to 32 roots' frontiers ride one word per vertex
    through a single bitwise-or pull per level (MS-BFS, Then et al. VLDB'15).

    roots_sorted_s: int32 [32] SCATTER-ordered root ids in [0, v_pad).
    Returns levels int16 [32, v_pad] in SCATTER ordering (UNVISITED = -1,
    root level = 1). The host reads one flag per level: whether any vertex
    was newly reached."""
    dev = graph.device
    shifts = torch.arange(32, dtype=torch.int32, device=dev)
    bits = torch.ones(32, dtype=torch.int32, device=dev) << shifts
    # duplicate roots carry distinct bits, so a scatter-add is an OR here
    seed = torch.zeros(graph.v_pad, dtype=torch.int32, device=dev).index_add_(
        0, roots_sorted_s.long(), bits)
    levels = torch.full((32, graph.v_pad), UNVISITED, dtype=torch.int16,
                        device=dev)
    levels.masked_fill_(((seed[None, :] >> shifts[:, None]) & 1) == 1,
                        FIRST_LEVEL)
    seen, frontier, cur = seed, seed, FIRST_LEVEL
    alive = bool(torch.any(seed != 0))
    while alive and cur < max_levels:
        reached_g = advance_pull_value(graph, frontier, "or", direction=G,
                                       src_in_src_order=True)
        reached_s = common.to_direction(graph, reached_g, G, S)
        newly = reached_s & ~seen
        levels.masked_fill_(((newly[None, :] >> shifts[:, None]) & 1) == 1,
                            cur + 1)
        seen, frontier, cur = seen | newly, newly, cur + 1
        alive = bool(torch.any(newly != 0))
    return levels


def vgl_msbfs(graph: VGLGraph, source_vertices,
              max_levels: int = 32767) -> VertexArray:
    """Multi-source BFS: levels int32 [k, v_pad] (SCATTER ordering) for k
    roots, 32 roots per bit-parallel word, the words one after another.
    Semantically identical to k vgl_bfs runs."""
    srcs = np.asarray(source_vertices, np.int64)
    k = len(srcs)
    w = (k + 31) // 32
    padded = np.zeros(w * 32, np.int64)
    padded[:k] = srcs
    # pad roots (beyond k) traverse as duplicates of root 0; their rows are
    # cut off below
    sid = graph.outgoing.orig_to_sorted[
        torch.from_numpy(padded).to(graph.device)].reshape(w, 32)
    levels = torch.cat([_msbfs_word(graph, sid[i], min(max_levels, 32766))
                        for i in range(w)])
    return VertexArray(values=levels[:k].to(torch.int32), direction=S)


def seq_top_down(ec, source_vertex) -> np.ndarray:
    """Sequential oracle: BFS levels, source=1, unvisited=-1 (reference
    seq_bfs); scipy, original ids. The matrix is bool, so duplicate edges
    cannot wrap an int8 sum into a negative weight (unweighted search reads
    no weights either way). source_vertex may be a list of vertices: then
    one row of levels per source, from one build of the matrix."""
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csg
    v = ec.vertices_count
    a = sp.csr_matrix((np.ones(ec.edges_count, bool),
                       (ec.src_ids, ec.dst_ids)), shape=(v, v))
    hops = csg.shortest_path(a, method="D", unweighted=True, directed=True,
                             indices=source_vertex)
    levels = np.full(hops.shape, UNVISITED, np.int32)
    reach = ~np.isinf(hops)
    levels[reach] = hops[reach].astype(np.int32) + FIRST_LEVEL
    return levels
