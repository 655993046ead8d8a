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

from ..config import TraversalDirection
from ..graph.device import VGLGraph
from ..graph.edges import EdgeArray
from ..models import common
from ..ops import monoid as M
from ..ops.advance import advance_pull_value
from .collectives import merge_all
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
                      src_active_o: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Combine the shards' pulls in turn on one card: S pull kernel
    launches and 2S vertex routes (3S with src_active_o). weights: one
    EdgeArray per shard (shard_build.shard_edge_values). "or" takes bool
    (reachability) and int words (bit-parallel frontiers) alike."""
    mon = M.get(combine)
    acc = None
    for s, g in enumerate(sg.shards):
        out = _shard_pull_original(
            g, x_o, combine, direction=direction,
            edge_values=None if weights is None
            else weights[s].direction(direction),
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


# ---------------------------------------------------------------------------
# one card, the shards in turn
# ---------------------------------------------------------------------------

def _scan_pull(sg: ShardedTileGraph,
               weights: Optional[List[EdgeArray]] = None) -> Callable:
    def pull(x_o, combine, **kw):
        return sharded_pull_scan(sg, x_o, combine, weights=weights, **kw)
    return pull


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
