"""Distributed algorithms over the sharded flagship container (port of
vectorgraphlibrary_tpu/parallel/sharded.py:44-273 and :664-978: PageRank,
BFS, SSSP, CC and HITS).

Execution model (the reference's MPI story): state lives REPLICATED in
ORIGINAL vertex order; each shard runs the single-card advance
(`ops/advance.advance_pull_value`: one CSR pull kernel launch) between two
vertex routes, and the per-destination partials combine over the shards.
Each destination's in-edges live wholly in its owner shard, so the combine
is really a disjoint-range join (reference `nec/advance_worker.hpp:239-264`,
`common/mpi_exchange.hpp:193-271`).

Two runners share the loop bodies:
- `make_*_sharded`: one shard per rank of a torch.distributed group
  (parallel/mesh.py), partials merged by one all-reduce over the mesh's
  edge axis (parallel/collectives.merge_all);
- `*_sharded_scan`: one card loops over the shards of a ShardedTileGraph
  and combines the partials into one accumulator (the reference's lax.scan
  over the stacked shards).

Each loop runs eagerly, as the port's single-card models do: the host
reads one convergence value per iteration (none for PageRank and HITS,
which run a fixed count).
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import TraversalDirection
from ..graph.device import VGLGraph
from ..graph.edges import DirectedEdgeValues, EdgeArray
from ..models import common
from ..models.coloring import _bit_position, _hash32
from ..ops import monoid as M
from ..ops.advance import advance_pull_value
from ..ops.cuda.pull_rows import RowCSR, pull_rows
from .collectives import (delta_capacity_policy, merge_all,
                          merge_changed_sparse, merge_or_words)
from .mesh import Mesh
from .shard_build import ShardedTileGraph

O, S, G = (TraversalDirection.ORIGINAL, TraversalDirection.SCATTER,
           TraversalDirection.GATHER)
_INF_I32 = torch.iinfo(torch.int32).max


def _shard_pull_original(g: VGLGraph, x_o: torch.Tensor, combine,
                         direction=G, edge_values=None, weight_op=None,
                         exclude_self_loops: bool = False,
                         src_active_o: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """One shard's pull with input and output in ORIGINAL ordering: two
    vertex routes per pull. The reference routes the input into the SOURCE
    side's ordering and passes src_in_src_order, because its advance route
    starts from source-grouped tile slots; the port's pull reads its
    sources in the pulled direction's own ordering (its CSR's col_idx), so
    the input goes straight there, one route fewer than src_in_src_order
    would cost here. src_active_o: optional bool [v_pad] ORIGINAL mask of
    message sources (the partial-active restriction,
    sssp/shortest_paths.hpp:135-141)."""
    x_d = common.to_direction(g, x_o, O, direction)
    act = (None if src_active_o is None
           else common.to_direction(g, src_active_o, O, direction))
    out = advance_pull_value(g, x_d, combine, edge_values=edge_values,
                             weight_op=weight_op,
                             exclude_self_loops=exclude_self_loops,
                             src_active=act, direction=direction)
    return common.to_direction(g, out, direction, O)


def pr_consts(ec):
    """Host precompute for PR in ORIGINAL space: (rev_deg, dangling_mask) over
    GLOBAL self-loop-excluded out-degrees (pr.hpp:6-148 semantics)."""
    v = ec.vertices_count
    nonloop = ec.src_ids != ec.dst_ids
    outdeg = np.bincount(ec.src_ids[nonloop], minlength=v).astype(np.float64)
    rev = np.where(outdeg > 0, 1.0 / np.maximum(outdeg, 1), 0.0)
    return rev.astype(np.float32), (outdeg == 0)


def _pad_v(arr, v_pad, fill=0):
    out = np.full(v_pad, fill, arr.dtype)
    out[:len(arr)] = arr
    return out


def sharded_pull_scan(sg: ShardedTileGraph, x_o: torch.Tensor, combine,
                      direction=G, weights: Optional[List[EdgeArray]] = None,
                      weight_op=None, exclude_self_loops: bool = False,
                      src_active_o: Optional[torch.Tensor] = None,
                      weight_fn: Optional[Callable] = None) -> torch.Tensor:
    """Combine the shards' pulls in turn on one card: S pull kernel
    launches and 2S vertex routes (3S with src_active_o). weights: one
    EdgeArray per shard (shard_build.shard_edge_values, or
    slot_weights_stacked); weight_fn(s, shard): shard s's incoming
    DirectedEdgeValues, made inside the sweep so that no shard's weights
    stay resident (slot_hash_weight_fn; GATHER pulls only). "or" takes
    bool (reachability) and int words (bit-parallel frontiers) alike."""
    if weight_fn is not None and direction != G:
        raise ValueError("weight_fn gives incoming weights: GATHER pulls only")
    mon = M.get(combine)
    acc = None
    for s, g in enumerate(sg.shards):
        if weight_fn is not None:
            ev = weight_fn(s, g)
        else:
            ev = None if weights is None else weights[s].direction(direction)
        out = _shard_pull_original(
            g, x_o, combine, direction=direction, edge_values=ev,
            weight_op=weight_op, exclude_self_loops=exclude_self_loops,
            src_active_o=src_active_o)
        acc = out if acc is None else mon.combine(acc, out)
    return acc


# ---------------------------------------------------------------------------
# the loop bodies, over a `pull(x_o, combine, direction=, weight_op=,
# exclude_self_loops=, src_active_o=)` that returns the combined partials
# ---------------------------------------------------------------------------

def _ids(v_pad: int, device) -> torch.Tensor:
    return torch.arange(v_pad, dtype=torch.int32, device=device)


def _pr_device_consts(ec, v_pad: int, device):
    """pr_consts(ec) padded to v_pad, on `device`."""
    rev, dmask = pr_consts(ec)
    return (torch.from_numpy(_pad_v(rev, v_pad)).to(device),
            torch.from_numpy(_pad_v(dmask, v_pad, fill=False)).to(device))


def _pagerank(pull: Callable, consts, v: int, v_pad: int, device,
              damping: float, max_iterations: int) -> torch.Tensor:
    real = _ids(v_pad, device) < v
    rev, dmask = consts
    k = (1.0 - damping) / v
    ranks = torch.where(real, 1.0 / v, 0.0).to(torch.float32)
    for _ in range(max_iterations):
        dangling = torch.sum(torch.where(dmask, ranks, 0.0)) / v
        acc = pull(ranks * rev, "add", direction=G, exclude_self_loops=True)
        acc = torch.where(real, acc, 0.0)
        ranks = torch.where(real, k + damping * (acc + dangling), 0.0)
    return ranks


def _bfs(pull: Callable, v: int, v_pad: int, device, source,
         max_levels: int) -> torch.Tensor:
    """Level-synchronous pull BFS: levels [v_pad] ORIGINAL, source level 1,
    unvisited -1 (reference convention)."""
    ids = _ids(v_pad, device)
    real = ids < v
    levels = torch.where(real & (ids == int(source)), 1, _INF_I32) \
        .to(torch.int32)
    size, cur = 1, 1
    while size > 0 and cur < max_levels:
        reached = pull(levels == cur, "or", direction=G) & real
        newly = reached & (levels == _INF_I32)
        levels = torch.where(newly, cur + 1, levels).to(torch.int32)
        size = int(newly.sum())
        cur += 1
    return torch.where(levels == _INF_I32, -1, levels).to(torch.int32)


def _sssp(pull: Callable, v: int, v_pad: int, device, source,
          partial: bool, max_iterations: int) -> tuple[torch.Tensor, int]:
    """Bellman-Ford to fixpoint; partial=True relaxes only edges out of the
    sources that changed in the last sweep. -> (dist, sweeps)."""
    ids = _ids(v_pad, device)
    real = ids < v
    changed = ids == int(source)
    dist = torch.where(real & changed, 0.0, torch.inf).to(torch.float32)
    it = 0
    while it < max_iterations and bool(changed.any()):
        cand = pull(dist, "min", direction=G, weight_op="add",
                    src_active_o=changed if partial else None)
        new = torch.minimum(dist, torch.where(real, cand, torch.inf))
        dist, changed, it = new, new < dist, it + 1
    return dist, it


def _cc(pull: Callable, v: int, v_pad: int, device,
        max_iterations: int) -> tuple[torch.Tensor, int]:
    """Shiloach-Vishkin over the undirected neighbourhood: hook = min over
    the pulls of both containers, jump = pointer halving every 4th
    iteration. -> (labels [v_pad] ORIGINAL, iterations)."""
    ids = _ids(v_pad, device)
    real = ids < v
    labels = torch.where(real, ids, v).to(torch.int32)
    prev = torch.full_like(labels, -1)
    it = 0
    while it < max_iterations and bool(torch.any(labels != prev)):
        m = torch.minimum(
            torch.where(real, pull(labels, "min", direction=G), _INF_I32),
            torch.where(real, pull(labels, "min", direction=S), _INF_I32))
        new = torch.minimum(labels, m)
        if it % 4 == 3:
            for _ in range(2):
                new = new[new.clamp(max=v_pad - 1).long()]
        labels, prev, it = torch.where(real, new, v).to(torch.int32), \
            labels, it + 1
    return labels, it


def _hits(pull: Callable, v: int, v_pad: int, device,
          iterations: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Alternating auth/hub pulls with L2 normalization (hits.hpp:5-176)."""
    real = (_ids(v_pad, device) < v).to(torch.float32)

    def normalize(x):
        n = torch.sqrt(torch.sum(x * x))
        return torch.where(n > 0, x / n, x)

    auth = hub = real
    for _ in range(iterations):
        auth = normalize(pull(hub, "add", direction=G) * real)
        hub = normalize(pull(auth, "add", direction=S) * real)
    return auth, hub


def _msbfs(pull: Callable, v: int, v_pad: int, device, roots,
           max_sweeps: int) -> tuple[torch.Tensor, int]:
    """Bit-parallel multi-source BFS: up to 32 roots ride one int32 word
    per vertex through one "or" pull per level (reference
    sharded.py:824-858). roots: 32 ORIGINAL ids (duplicates fine). ->
    (levels int8 [32, v_pad] ORIGINAL (root level 1, unvisited -1), the
    pulls run); at most max_sweeps pulls, so levels reach max_sweeps + 1
    (the callers keep that within int8)."""
    real = _ids(v_pad, device) < v
    shifts = torch.arange(32, dtype=torch.int32, device=device)
    bits = torch.bitwise_left_shift(torch.ones_like(shifts), shifts)
    # duplicate roots carry distinct bits, so a scatter-add is an OR here
    seed = torch.zeros(v_pad, dtype=torch.int32, device=device).index_add_(
        0, torch.as_tensor(roots, device=device).long(), bits)
    seed = torch.where(real, seed, 0)
    levels = torch.where(((seed[None, :] >> shifts[:, None]) & 1) == 1, 1,
                         -1).to(torch.int8)
    seen, frontier, cur = seed, seed, 1
    alive = bool(torch.any(seed != 0))
    while alive and cur <= max_sweeps:
        reached = torch.where(real, pull(frontier, "or", direction=G), 0)
        newly = reached & ~seen
        levels.masked_fill_(((newly[None, :] >> shifts[:, None]) & 1) == 1,
                            cur + 1)
        seen, frontier, cur = seen | newly, newly, cur + 1
        alive = bool(torch.any(newly != 0))
    return levels, cur - 1


def _cc_hybrid(und: Callable, v: int, v_pad: int, device, hub,
               max_flood_levels: int, max_iterations: int
               ) -> tuple[torch.Tensor, int, int]:
    """Flood-hybrid CC (reference sharded.py:861-938): a bool or-flood of
    the hub's weak component over both CSRs, frozen at the hub's id only
    if the flood closed (the non-closure guard: freeze = reach & ~any(the
    last frontier)), then hook-min iterations with no pointer jumps for
    the rest. und(x, combine): x pulled over both directions, combined. ->
    (labels [v_pad] ORIGINAL, flood levels, hook iterations)."""
    ids = _ids(v_pad, device)
    real = ids < v
    hub = int(hub)
    reach = frontier = ids == hub
    flood = 0
    while flood < max_flood_levels and bool(frontier.any()):
        newly = und(frontier, "or") & ~reach & real
        reach, frontier, flood = reach | newly, newly, flood + 1
    freeze = reach & ~frontier.any()
    labels = torch.where(real, torch.where(freeze, hub, ids), v) \
        .to(torch.int32)
    prev = torch.full_like(labels, -1)
    it = 0
    while it < max_iterations and bool(torch.any(labels != prev)):
        m = und(labels, "min")
        new = torch.where(freeze, hub, torch.minimum(labels, m))
        labels, prev, it = torch.where(real, new, v).to(torch.int32), \
            labels, it + 1
    return labels, flood, it


def _coloring(und: Callable, v: int, v_pad: int, device, seed: int,
              words: int, max_rounds: int) -> torch.Tensor:
    """Jones-Plassmann greedy coloring (reference sharded.py:274-359,
    coloring.hpp:66-158): each round the uncolored vertices whose random
    priority beats every uncolored neighbour's take their smallest free
    color among the first 32 * words (banned-color words pulled over both
    directions), or, with all of them banned, their neighbours' largest
    color + 1. Priorities: np.random.default_rng(seed).permutation(v).
    -> colors [v_pad] ORIGINAL."""
    real = _ids(v_pad, device) < v
    prio_np = np.full(v_pad, _INF_I32, np.int32)
    prio_np[:v] = np.random.default_rng(seed).permutation(v)
    prio = torch.from_numpy(prio_np).to(device)
    win = words * 32
    colors = torch.where(real, -1, 0).to(torch.int32)
    rnd, assigned = 0, 1
    while assigned > 0 and rnd < max_rounds:
        uncolored = colors == -1
        nb_best = und(torch.where(uncolored, prio, _INF_I32), "min")
        winner = uncolored & real & (prio <= nb_best)
        cand = torch.full_like(colors, win)
        for w in range(words):
            mine = (colors >= 0) & (colors // 32 == w)
            bw = und(torch.where(mine, torch.bitwise_left_shift(
                torch.ones_like(colors), colors % 32), 0), "or")
            free = (~bw).to(torch.int64) & 0xFFFFFFFF
            pos = _bit_position(free & -free)
            cand = torch.minimum(cand, torch.where(free != 0, 32 * w + pos,
                                                   win).to(torch.int32))
        max_nb = und(torch.where(colors >= 0, colors, -1), "max")
        colors = torch.where(winner, torch.where(
            cand < win, cand, torch.clamp(max_nb, min=win - 1) + 1),
            colors).to(torch.int32)
        rnd, assigned = rnd + 1, int(winner.sum())
    return colors


# ---------------------------------------------------------------------------
# one card, the shards in turn
# ---------------------------------------------------------------------------

def _scan_pull(sg: ShardedTileGraph,
               weights: Optional[List[EdgeArray]] = None,
               weight_fn: Optional[Callable] = None) -> Callable:
    def pull(x_o, combine, **kw):
        return sharded_pull_scan(sg, x_o, combine, weights=weights,
                                 weight_fn=weight_fn, **kw)
    return pull


def _scan_und(sg: ShardedTileGraph) -> Callable:
    """x pulled over both directions, each over the shards in turn, and
    the two combined: 2S pull launches, 4S vertex routes."""
    def und(x_o, combine):
        return M.get(combine).combine(
            sharded_pull_scan(sg, x_o, combine, direction=G),
            sharded_pull_scan(sg, x_o, combine, direction=S))
    return und


def pagerank_sharded_scan(sg: ShardedTileGraph, ec,
                          max_iterations: int = 100) -> torch.Tensor:
    """One-card PageRank over the shards in turn; [v_pad] ORIGINAL. ec:
    the COO the graph was built from. Its degree constants (pr_consts, a
    host pass over every edge) are made at the first call and kept with
    the graph, as make_pr_sharded makes them once, before its run()."""
    consts = sg.derived("pr_consts", lambda: _pr_device_consts(
        ec, sg.v_pad, sg.device))
    return _pagerank(_scan_pull(sg), consts, sg.v, sg.v_pad, sg.device,
                     0.85, max_iterations)


def pr_consts_on(sg: ShardedTileGraph, rev, dmask) -> tuple:
    """The degree constants (rev, dmask as pr_consts gives them, [v] or
    [v_pad], numpy or torch: a builder's .prconsts.npz) padded to v_pad on
    the graph's device; a [v_pad] tensor already there is kept as it is."""
    def on(a, fill):
        if isinstance(a, torch.Tensor) and a.device == sg.device \
                and a.numel() == sg.v_pad:
            return a
        return torch.as_tensor(_pad_v(np.asarray(a), sg.v_pad, fill)).to(
            sg.device)
    return on(rev, 0), on(dmask, False)


def pagerank_sharded_scan_consts(sg: ShardedTileGraph, rev, dmask,
                                 max_iterations: int = 100) -> torch.Tensor:
    """pagerank_sharded_scan from the degree constants themselves (as
    pr_consts_on takes them; its device tensors copy nothing per call),
    for a graph whose edges are not at hand."""
    return _pagerank(_scan_pull(sg), pr_consts_on(sg, rev, dmask), sg.v,
                     sg.v_pad, sg.device, 0.85, max_iterations)


def hits_sharded_scan(sg: ShardedTileGraph, iterations: int = 20
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """One-card HITS over the shards in turn; (auth, hub) [v_pad] ORIGINAL."""
    return _hits(_scan_pull(sg), sg.v, sg.v_pad, sg.device, iterations)


def bfs_sharded_scan(sg: ShardedTileGraph, source,
                     max_levels: int = 10_000) -> torch.Tensor:
    """One-card level-synchronous pull BFS over the shards in turn;
    levels [v_pad] ORIGINAL (source level 1, unvisited -1)."""
    return _bfs(_scan_pull(sg), sg.v, sg.v_pad, sg.device, source,
                max_levels)


def cc_sharded_scan(sg: ShardedTileGraph, max_iterations: int = 1000
                    ) -> tuple[torch.Tensor, int]:
    """One-card Shiloach-Vishkin over the shards in turn;
    -> (labels [v_pad] ORIGINAL, iterations run)."""
    return _cc(_scan_pull(sg), sg.v, sg.v_pad, sg.device, max_iterations)


def msbfs_sharded_scan(sg: ShardedTileGraph, roots,
                       max_levels: int = 32766) -> torch.Tensor:
    """One-card bit-parallel multi-source BFS over the shards in turn (the
    scan twin of models/bfs.vgl_msbfs): roots, 32 ORIGINAL ids -> levels
    int8 [32, v_pad] ORIGINAL (root level 1, unvisited -1; int8 keeps the
    state small at scale, so depth is capped at 126). One pull per shard
    and level."""
    return _msbfs(_scan_pull(sg), sg.v, sg.v_pad, sg.device, roots,
                  min(max_levels, 126) - 1)[0]


def cc_hybrid_sharded_scan(sg: ShardedTileGraph, hub,
                           max_flood_levels: int = 1000,
                           max_iterations: int = 1000
                           ) -> tuple[torch.Tensor, int, int]:
    """One-card flood-hybrid CC over the shards in turn (the reference's
    own BFS-based CC, algorithms/cc/bfs_based.hpp, is the same idea):
    phase A floods the hub's weak component with bool or-pulls over both
    CSRs and freezes it at one label; phase B hook-mins the rest. Correct
    for any hub (callers pass the largest out-degree vertex; a poor choice
    costs only time). -> (labels [v_pad] ORIGINAL, flood levels, hook
    iterations)."""
    return _cc_hybrid(_scan_und(sg), sg.v, sg.v_pad, sg.device, hub,
                      max_flood_levels, max_iterations)


def coloring_sharded_scan(sg: ShardedTileGraph, seed: int = 0,
                          words: int = 4, max_rounds: int = 10_000
                          ) -> torch.Tensor:
    """One-card twin of make_coloring_sharded (the JAX package has none):
    the same rounds over the shards in turn; colors [v_pad] ORIGINAL."""
    return _coloring(_scan_und(sg), sg.v, sg.v_pad, sg.device, seed, words,
                     max_rounds)


def sssp_sharded_scan(sg: ShardedTileGraph, weights: List[EdgeArray],
                      source, partial: bool = True,
                      max_iterations: int = 10_000
                      ) -> tuple[torch.Tensor, int]:
    """One-card Bellman-Ford over the shards in turn. weights: the shards'
    EdgeArrays (shard_build.shard_edge_values). partial=True relaxes only
    edges out of recently-changed sources (src_active masking,
    sssp/shortest_paths.hpp:135-141); partial=False is the all-active
    sweep. -> (dist [v_pad] ORIGINAL, sweeps run)."""
    return _sssp(_scan_pull(sg, weights), sg.v, sg.v_pad, sg.device, source,
                 partial, max_iterations)


# ---------------------------------------------------------------------------
# one shard per rank
# ---------------------------------------------------------------------------

def _rank_pull(g: VGLGraph, mesh: Mesh,
               weights: Optional[EdgeArray] = None) -> Callable:
    """This rank's shard pull, merged over the mesh's edge axis."""
    def pull(x_o, combine, direction=G, **kw):
        out = _shard_pull_original(
            g, x_o, combine, direction=direction,
            edge_values=None if weights is None
            else weights.direction(direction), **kw)
        return merge_all(out, combine, mesh.e_group)
    return pull


def _rank_und(g: VGLGraph, mesh: Mesh) -> Callable:
    """This rank's shard pulled over both directions, combined, then
    merged over the mesh's edge axis once. An "or" of int words merges by
    collectives.merge_or_words (all_gather and bitwise or): a SCATTER
    pull leaves each source a partial word in every shard, and those
    words differ, so merge_all's unsigned max would lose bits (reference
    sharded.py:304-312). Bools merge by merge_all, where max is or."""
    def und(x_o, combine):
        both = M.get(combine).combine(
            _shard_pull_original(g, x_o, combine, direction=G),
            _shard_pull_original(g, x_o, combine, direction=S))
        if combine == "or" and both.dtype != torch.bool:
            return merge_or_words(both, mesh.e_group)
        return merge_all(both, combine, mesh.e_group)
    return und


def make_pr_sharded(g: VGLGraph, mesh: Mesh, ec, damping: float = 0.85,
                    max_iterations: int = 100) -> Callable:
    """run() -> ranks [v_pad] ORIGINAL, replicated on every rank. g: this
    rank's shard (shard_build.import_shard, or sg.shard(rank)); every rank
    of the mesh's edge axis calls run() together."""
    consts = _pr_device_consts(ec, g.v_pad, g.device)

    def run():
        return _pagerank(_rank_pull(g, mesh), consts, g.v, g.v_pad,
                         g.device, damping, max_iterations)
    return run


def make_bfs_sharded(g: VGLGraph, mesh: Mesh,
                     max_levels: int = 10_000) -> Callable:
    """Level-synchronous pull BFS: (source) -> levels [v_pad] ORIGINAL
    (source level 1, unvisited -1)."""
    def run(source):
        return _bfs(_rank_pull(g, mesh), g.v, g.v_pad, g.device, source,
                    max_levels)
    return run


def make_sssp_sharded(g: VGLGraph, mesh: Mesh, weights: EdgeArray,
                      max_iterations: int = 10_000) -> Callable:
    """All-active Bellman-Ford: (source) -> dist [v_pad] ORIGINAL. weights:
    this rank's shard's EdgeArray (shard_build.edge_values_of_shard)."""
    def run(source):
        return _sssp(_rank_pull(g, mesh, weights), g.v, g.v_pad, g.device,
                     source, False, max_iterations)[0]
    return run


def make_cc_sharded(g: VGLGraph, mesh: Mesh,
                    max_iterations: int = 1000) -> Callable:
    """Shiloach-Vishkin: () -> labels [v_pad] ORIGINAL."""
    def run():
        return _cc(_rank_pull(g, mesh), g.v, g.v_pad, g.device,
                   max_iterations)[0]
    return run


def make_hits_sharded(g: VGLGraph, mesh: Mesh,
                      iterations: int = 20) -> Callable:
    """HITS: () -> (auth, hub) [v_pad] ORIGINAL."""
    def run():
        return _hits(_rank_pull(g, mesh), g.v, g.v_pad, g.device, iterations)
    return run


def make_msbfs_sharded(g: VGLGraph, mesh: Mesh,
                       max_levels: int = 126) -> Callable:
    """Bit-parallel multi-source BFS: (roots, 32 ORIGINAL ids) -> levels
    int8 [32, v_pad] ORIGINAL (the twin of msbfs_sharded_scan). One
    GATHER "or" pull per level and one merge: one rank owns each
    destination, so merge_all's unsigned max is the or."""
    def run(roots):
        return _msbfs(_rank_pull(g, mesh), g.v, g.v_pad, g.device, roots,
                      min(max_levels, 126) - 1)[0]
    return run


def make_cc_hybrid_sharded(g: VGLGraph, mesh: Mesh,
                           max_flood_levels: int = 1000,
                           max_iterations: int = 1000) -> Callable:
    """Flood-hybrid CC: (hub) -> (labels [v_pad] ORIGINAL, flood levels,
    hook iterations), the twin of cc_hybrid_sharded_scan; each flood level
    and hook one merge of both directions' pulls."""
    def run(hub):
        return _cc_hybrid(_rank_und(g, mesh), g.v, g.v_pad, g.device, hub,
                          max_flood_levels, max_iterations)
    return run


def make_coloring_sharded(g: VGLGraph, mesh: Mesh, seed: int = 0,
                          words: int = 4,
                          max_rounds: int = 10_000) -> Callable:
    """Distributed Jones-Plassmann: () -> colors [v_pad] ORIGINAL. Per
    round the best uncolored neighbour's priority (min merge), `words`
    banned-color words (all_gather and bitwise or: _rank_und) and the
    neighbours' largest color (max merge)."""
    def run():
        return _coloring(_rank_und(g, mesh), g.v, g.v_pad, g.device, seed,
                         words, max_rounds)
    return run


def make_sssp_sharded_partial(g: VGLGraph, mesh: Mesh, weights: EdgeArray,
                              delta_capacity: Optional[int] = None,
                              max_iterations: int = 10_000) -> Callable:
    """Partial-active Bellman-Ford, the reference's work-frontier MPI SSSP
    (sssp/shortest_paths.hpp:135-141): each sweep pulls candidates from
    the sources that changed in the last one (src_active) and merges the
    distances by the compacted changed-only exchange
    (collectives.merge_changed_sparse, the dense merge when a rank's
    changes overflow the capacity delta_capacity_policy allows). (source)
    -> dist [v_pad] ORIGINAL. weights: this rank's shard's EdgeArray."""
    cap = delta_capacity_policy(g.v_pad, mesh.n_edge * mesh.n_vertex,
                                requested=delta_capacity)

    def run(source):
        ids = _ids(g.v_pad, g.device)
        real = ids < g.v
        changed = ids == int(source)
        dist = torch.where(real & changed, 0.0, torch.inf).to(torch.float32)
        it = 0
        while it < max_iterations and bool(changed.any()):
            cand = _shard_pull_original(g, dist, "min", direction=G,
                                        edge_values=weights.incoming,
                                        weight_op="add", src_active_o=changed)
            local = torch.minimum(dist, torch.where(real, cand, torch.inf))
            new = merge_changed_sparse(local, dist, "min", cap, mesh.e_group)
            dist, changed, it = new, new < dist, it + 1
        return dist
    return run


def make_bfs_do_sharded(g: VGLGraph, mesh: Mesh, alpha: float = 15.0,
                        beta: float = 18.0, id_cap: int = 1 << 12,
                        edge_cap: int = 1 << 16,
                        max_levels: int = 10_000) -> Callable:
    """Direction-optimizing BFS (reference hardwired_do_bfs.hpp:925-990):
    each level Beamer's test, on the global frontier size and its global
    out-edge count, picks top-down (the frontier compacted to id_cap ids
    in SCATTER order, advance_push_sparse of level + 1 over the shard's
    outgoing CSR into edge_cap edge slots, a min merge) or bottom-up (the
    GATHER or-pull and its merge). Levels stay replicated in ORIGINAL
    order; the global out-degrees and edge count are all-reduced once,
    and the host reads the frontier's size and out-edges once per level.
    (source) -> levels [v_pad] ORIGINAL (source 1, unvisited -1)."""
    from ..graph.frontier import Frontier, compact_ids
    from ..ops.advance import advance_push_sparse
    v, v_pad = g.v, g.v_pad
    id_cap = min(id_cap, v_pad)
    ids = _ids(v_pad, g.device)
    real = ids < v
    f32 = np.float32
    outdeg_o = merge_all(common.to_direction(g, g.outgoing.degrees, S, O),
                         "add", mesh.e_group)
    e_total = int(merge_all(torch.tensor([g.incoming.e], device=g.device),
                            "add", mesh.e_group))

    def top_down(levels, cur):
        levels_s = common.to_direction(g, levels, O, S)
        mask_s = levels_s == cur
        fr = Frontier(mask=mask_s, size=torch.sum(mask_s, dtype=torch.int32),
                      neighbours_count=torch.zeros((), dtype=torch.int32,
                                                   device=g.device),
                      direction=S)
        sid, valid = compact_ids(fr, id_cap)
        out_s = advance_push_sparse(
            g, sid, valid, edge_cap, {"l": levels_s},
            lambda s, d, w: torch.zeros_like(s["l"]) + (cur + 1), "min",
            levels_s, direction=S)
        out_o = common.to_direction(g, out_s, S, O)
        return torch.minimum(levels, merge_all(
            torch.where(real, out_o, _INF_I32), "min", mesh.e_group))

    def bottom_up(levels, cur):
        reached = merge_all(_shard_pull_original(g, levels == cur, "or",
                                                 direction=G) & real,
                            "or", mesh.e_group)
        return torch.where((levels == _INF_I32) & reached, cur + 1, levels)

    def run(source):
        levels = torch.where(real & (ids == int(source)), 1, _INF_I32) \
            .to(torch.int32)
        size, nbrs = 1, int(outdeg_o[int(source)])
        cur, unexplored = 1, min(e_total, 2**31 - 1)
        while size > 0 and cur < max_levels:
            td_ok = (((f32(nbrs) < f32(unexplored) / f32(alpha))
                      or (f32(size) * f32(beta) < f32(v)))
                     and size < id_cap and nbrs < edge_cap)
            new = (top_down if td_ok else bottom_up)(levels, cur)
            newly = new < levels
            size, nbrs = common.read_scalars(
                torch.sum(newly, dtype=torch.int32),
                torch.sum(torch.where(newly, outdeg_o, 0), dtype=torch.int32))
            levels, cur = new.to(torch.int32), cur + 1
            unexplored = max(unexplored - nbrs, 0)
        return torch.where(levels == _INF_I32, -1, levels).to(torch.int32)
    return run


# ---------------------------------------------------------------------------
# edge weights by route slot
# ---------------------------------------------------------------------------

def route_slot_count(g: VGLGraph) -> int:
    """n, the advance route's slot count, from the tiles' slot counts (as
    route_build.build_pull_permutation pads them); a slim shard keeps
    those counts but not the route."""
    return common.next_pow2(max(g.out_slots, g.in_slots, 256))


def slot_hash_weights(slots: torch.Tensor, shard: int, lo: float = 0.01,
                      hi: float = 1.0) -> torch.Tensor:
    """The JAX package's weight of incoming route slot `slots` of shard
    `shard` (reference sharded.py:999-1024), bit for bit: lowbias32 of
    slot + (shard + 1) * 0x9E3779B9 modulo 2^32, its top 24 bits u / 2^24,
    then f32(lo) + f32(hi - lo) * u rounded once to f32, as the reference's
    compiled scan computes it (XLA fuses the product and the sum into one
    fused multiply-add; called eagerly, it rounds twice and differs in the
    last bit on about a fifth of the slots). The sum is exact in f64 (a
    48-bit product and f32(lo)), so its one rounding to f32 is the fused
    multiply-add's. The uint32 mix runs on int64."""
    golden = ((shard + 1) * 0x9E3779B9) & 0xFFFFFFFF
    x = _hash32((slots.to(torch.int64) + golden) & 0xFFFFFFFF)
    u = (x >> 8).to(torch.float64) / float(1 << 24)
    f32 = np.float32
    return (float(f32(lo)) + float(f32(hi - lo)) * u).to(torch.float32)


def _csr_weights(w: torch.Tensor, g: VGLGraph) -> torch.Tensor:
    """A shard's incoming weights in CSR slot order, f32 [e], padded with
    zeros to its incoming col_idx's length (a full shard's col_idx runs to
    the unified e_pad, a slim shard's ends at e), as the pull takes them."""
    pad = g.incoming.col_idx.numel() - w.numel()
    return w if pad == 0 else torch.cat([w, w.new_zeros(pad)])


def slot_hash_weight_fn(n: int, lo: float = 0.01, hi: float = 1.0
                        ) -> Callable:
    """fn(s, shard) -> shard s's incoming DirectedEdgeValues: every
    incoming route slot is one edge, so w = hash(slot, s) is an edge
    weight that needs no stored values (slot_hash_weights), made on the
    shard's device from its in_route_slots in CSR slot order, where the
    pull reads it. Only GATHER pulls may take it: the same edge's
    outgoing slot would hash otherwise. n: the route's slot count
    (route_slot_count), which every shard of a graph shares."""
    def fn(s: int, g: VGLGraph) -> DirectedEdgeValues:
        if route_slot_count(g) != n:
            raise ValueError(f"shard {s} has {route_slot_count(g)} route "
                             f"slots, not {n}")
        return DirectedEdgeValues(flat=_csr_weights(
            slot_hash_weights(g.in_route_slots, s, lo, hi), g))
    return fn


def slot_weights_stacked(slot_w, sg: ShardedTileGraph) -> List[EdgeArray]:
    """Stored weights in route-slot order (f32 [S, n], or S arrays of [n]:
    persistence.load_sharded_weights, the JAX package's layout) as one
    EdgeArray per shard in CSR slot order, the incoming direction's
    (the outgoing direction's values are empty, as the reference's): the
    stored twin of slot_hash_weight_fn."""
    out = []
    for s, g in enumerate(sg.shards):
        w = torch.as_tensor(slot_w[s], dtype=torch.float32)
        out.append(EdgeArray(
            outgoing=DirectedEdgeValues(flat=torch.zeros(
                0, dtype=torch.float32, device=g.device)),
            incoming=DirectedEdgeValues(flat=_csr_weights(
                w.to(g.device)[g.in_route_slots.long()], g))))
    return out


def route_slot_weights(sg: ShardedTileGraph,
                       weights: List[EdgeArray]) -> List[torch.Tensor]:
    """The inverse of slot_weights_stacked: each shard's incoming weights
    (CSR slot order) in route-slot order, f32 [n], 0 on the slots that hold
    no edge, as persistence.save_sharded_weights stores them."""
    out = []
    for g, w in zip(sg.shards, weights):
        e = g.incoming.e
        slots = torch.zeros(route_slot_count(g), dtype=torch.float32,
                            device=g.device)
        slots[g.in_route_slots[:e].long()] = \
            w.incoming.flat[:e].to(torch.float32)
        out.append(slots)
    return out


def sssp_sharded_scan_hash(sg: ShardedTileGraph, source, partial: bool = True,
                           max_iterations: int = 10_000, lo: float = 0.01,
                           hi: float = 1.0) -> tuple[torch.Tensor, int]:
    """SSSP over the shards in turn (slim or full) with slot-hash weights
    (slot_hash_weight_fn), made per shard inside each sweep. -> (dist
    [v_pad] ORIGINAL, sweeps run)."""
    fn = slot_hash_weight_fn(route_slot_count(sg.shard(0)), lo, hi)
    return _sssp(_scan_pull(sg, weight_fn=fn), sg.v, sg.v_pad, sg.device,
                 source, partial, max_iterations)


# ---------------------------------------------------------------------------
# GraphSAGE, one shard per rank
# ---------------------------------------------------------------------------

def _original_csr(g: VGLGraph) -> tuple:
    """The shard's GATHER CSR renumbered into ORIGINAL ids: row o lists
    the ORIGINAL ids of o's in-neighbours in this shard, in the GATHER
    CSR's order, so the features need no permutation. Made on the shard's
    device from the CSR and the GATHER vertex route (whose gather indices
    are the renumber maps, padding included). -> (row_ptr, col_idx,
    in-degrees [v_pad] f32), ORIGINAL."""
    dg = g.incoming
    o_of_g = g.vertex_route_g_from_o.fwd_idx.long()     # sorted -> orig
    g_of_o = g.vertex_route_g_from_o.inv_idx.long()     # orig -> sorted
    deg_o = dg.degrees[g_of_o]
    row_ptr = torch.zeros(g.v_pad + 1, dtype=torch.int32, device=g.device)
    row_ptr[1:] = torch.cumsum(deg_o, 0)
    rows = torch.repeat_interleave(
        torch.arange(g.v_pad, device=g.device), dg.degrees.long(),
        output_size=dg.e)
    k = torch.arange(dg.e, device=g.device) - dg.row_ptr[rows].long()
    col_idx = torch.empty_like(dg.col_idx)
    col_idx[dg.e:] = dg.col_idx[dg.e:]
    col_idx[row_ptr[o_of_g[rows]].long() + k] = \
        o_of_g[dg.col_idx[:dg.e].long()].to(torch.int32)
    return row_ptr, col_idx, deg_o.to(torch.float32)


class _ShardNeighbourSum(torch.autograd.Function):
    """out = the sum of the shard partial sums pull_rows gives over the
    ranks (all_reduce); its gradient likewise, over the transposed CSR.
    Every rank holds the whole replicated cotangent, and each rank's
    transposed pull covers only its own shard's edges, so the all_reduce
    of those partials is the whole gradient, the same on every rank (the
    JAX package's psum transposes the same way). torch.distributed.nn's
    all_reduce would instead all-reduce the cotangent itself and scale
    the aggregation's share of the gradient by the rank count."""

    @staticmethod
    def forward(ctx, x, csr, csr_t, group):
        ctx.csr_t, ctx.group = csr_t, group
        out = pull_rows(csr, x.contiguous())
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        out = pull_rows(ctx.csr_t(), grad.contiguous())
        dist.all_reduce(out, group=ctx.group)
        return out, None, None, None


def make_sage_loss_sharded(g: VGLGraph, mesh: Mesh) -> Callable:
    """GraphSAGE's 2-layer mean-aggregate forward and masked cross-entropy
    (the reference's make_sage_loss_sharded, sharded.py:606-642): features,
    labels, mask and params replicated in ORIGINAL order, the aggregation
    split over the ranks' shards (pull_rows over the shard's GATHER CSR in
    ORIGINAL ids, partial sums and the in-degrees merged by all-reduce).
    Returns loss_fn(params, feats, labels, mask) -> 0-d loss; its backward
    leaves every rank the same whole gradient, so the parameters need no
    all-reduce afterwards. Three pull_rows launches per training step, as
    the unsharded models/gnn step."""
    from ..models.gnn import transpose_csr

    def original():
        row_ptr, col_idx, deg = _original_csr(g)
        return RowCSR(row_ptr, col_idx), merge_all(deg, "add", mesh.e_group)

    def transposed():
        """The transposed CSR, made at the first backward and kept."""
        csr = g.derived("sage_csr", original)[0]
        return g.derived("sage_csr_t", lambda: RowCSR(*transpose_csr(
            csr.row_ptr, csr.col_idx, g.v_pad, g.incoming.e)))

    def loss_fn(params, feats, labels, mask):
        csr, cnt = g.derived("sage_csr", original)

        def agg_mean(h):
            ssum = _ShardNeighbourSum.apply(h, csr, transposed, mesh.e_group)
            return ssum / torch.clamp(cnt, min=1)[:, None]
        h = torch.relu(feats @ params.w_self1 + agg_mean(feats)
                       @ params.w_nbr1 + params.b1)
        logits = h @ params.w_self2 + agg_mean(h) @ params.w_nbr2 + params.b2
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(1, labels.long()[:, None])[:, 0]
        m = mask & (_ids(g.v_pad, g.device) < g.v)
        return torch.where(m, nll, 0.0).sum() / torch.clamp(m.sum(), min=1)
    return loss_fn


def make_sage_train_step_sharded(g: VGLGraph, mesh: Mesh,
                                 optimizer: torch.optim.Optimizer
                                 ) -> Callable:
    """step(params, feats, labels, mask): one optimizer step on params (the
    optimizer's) in place on every rank, returning the loss before it (a
    0-d tensor), as models/gnn.make_train_step."""
    loss_fn = make_sage_loss_sharded(g, mesh)

    def step(params, feats, labels, mask):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, feats, labels, mask)
        loss.backward()
        optimizer.step()
        return loss.detach()
    return step
