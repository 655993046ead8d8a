"""SSSP — Bellman-Ford family (the reference names it "dijkstra"; port of
vectorgraphlibrary_tpu/models/sssp.py).

Capability match for the reference SSSP
(`algorithms/sssp/shortest_paths.hpp:5-317`): all-active push (:85-162),
all-active pull (:170-280), and partial-active work-frontier variants.

- An all-active relaxation is one pull over incoming edges, min-combining
  dist[src] + w (one CSR pull kernel launch), swept to the fixpoint with the
  reduce-changes test the reference performs (:143-152).
- The partial-active variants keep a changed-vertex frontier: the compacted
  sparse push when it is small (`advance_push_sparse` with the edge weights,
  whose combine is the f32 min of the scatter-combine kernel), the dense pull
  restricted to changed sources otherwise (the reference's DENSE/SPARSE
  threshold switch, settings.h:111-125).

The reference runs its loops inside compiled programs (`lax.while_loop`,
`lax.switch`); here they are host loops that read each sweep's scalars back
in one transfer and pick the same branch by the same test, so distances and
iteration counts match the reference.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import TraversalDirection
from ..graph.device import VGLGraph
from ..graph.edges import EdgeArray
from ..graph.frontier import Frontier, compact_ids
from ..graph.vertices import VertexArray
from ..ops.advance import advance_pull_value, advance_push_sparse
from ..ops.frontier_ops import generate_new_frontier
from ..runtime.profiling import annotate
from . import common

S, G = TraversalDirection.SCATTER, TraversalDirection.GATHER


def _source_state(graph: VGLGraph, sid) -> tuple[torch.Tensor, torch.Tensor]:
    """(dist, changed) with only the source reached: dist inf but 0 at sid,
    changed False but True at sid."""
    dist = torch.full((graph.v_pad,), torch.inf, dtype=torch.float32,
                      device=graph.device)
    dist[sid] = 0.0
    changed = torch.zeros(graph.v_pad, dtype=torch.bool, device=graph.device)
    changed[sid] = True
    return dist, changed


def _all_active_run(graph: VGLGraph, weights_in, source_sorted_gather,
                    max_iterations: int) -> tuple[torch.Tensor, int]:
    """Bellman-Ford to fixpoint (GATHER ordering)."""

    def relax(dist):
        with annotate("vgl.sssp.sweep.all"):
            cand = advance_pull_value(graph, dist, "min",
                                      edge_values=weights_in,
                                      weight_op="add", direction=G)
            return torch.minimum(dist, cand)

    with annotate("vgl.sssp"):
        # indexing by the source's device id reads the id on the host
        with annotate("vgl.host_read"):
            dist0, _ = _source_state(graph, source_sorted_gather)
        return common.fixpoint(relax, dist0, max_iterations)


def vgl_dijkstra_all_active(graph: VGLGraph, weights: EdgeArray,
                            source_vertex: int,
                            max_iterations: int = 10_000
                            ) -> tuple[VertexArray, int]:
    """All-active Bellman-Ford (the reference's push (:85) and pull (:170)
    variants differ only in which container they traverse; this traverses
    incoming)."""
    sid = graph.incoming.orig_to_sorted[source_vertex].long()
    dist, iters = _all_active_run(graph, weights.incoming, sid,
                                  max_iterations)
    return VertexArray(values=dist, direction=G), iters


def _relax_edge(s, d, w):
    return s["d"] + w


def _partial_push_step(graph: VGLGraph, weights_out, dist, ids, valid,
                       ecap: int):
    """Sparse relax from changed vertices (SCATTER ordering)."""
    out = advance_push_sparse(graph, ids, valid, ecap, {"d": dist},
                              _relax_edge, "min", dist,
                              edge_values=weights_out, direction=S)
    changed = out < dist
    size = torch.sum(changed, dtype=torch.int32)
    nbrs = torch.sum(torch.where(changed, graph.outgoing.degrees, 0),
                     dtype=torch.int32)
    return out, changed, size, nbrs


def _partial_dense_step(graph: VGLGraph, weights_in, dist_g, changed_g):
    """Dense relax restricted to messages from changed sources (GATHER
    ordering). The changed-vertex frontier comes out of generate_new_frontier
    like the reference's GNF-on-distance-change."""
    cand = advance_pull_value(graph, dist_g, "min", edge_values=weights_in,
                              weight_op="add", src_active=changed_g,
                              direction=G)
    out = torch.minimum(dist_g, cand)
    fr = generate_new_frontier(
        graph, lambda ids, degs, arr: arr["new"] < arr["old"],
        {"new": out, "old": dist_g}, direction=G)
    return out, fr.mask, fr.size


def vgl_dijkstra_partial_active(graph: VGLGraph, weights: EdgeArray,
                                source_vertex: int,
                                dense_threshold: float = 0.05,
                                max_iterations: int = 10_000
                                ) -> tuple[VertexArray, int]:
    """Work-frontier Bellman-Ford: only changed vertices relax their edges
    (reference partial-active variant via GNF on distance change). The state
    lives in SCATTER ordering while the frontier is sparse and in GATHER
    ordering while it is dense."""
    v, e, v_pad = graph.v, graph.e, graph.v_pad
    dev = graph.device
    sid = int(graph.outgoing.orig_to_sorted[source_vertex])
    dist, changed = _source_state(graph, sid)
    size = 1
    nbrs = int(graph.outgoing.degrees[sid])
    state = "sparse"   # ordering: sparse -> SCATTER, dense -> GATHER
    outdeg_g = common.outdegrees_in(graph, G)
    iters = 0

    while size > 0 and iters < max_iterations:
        want_dense = size > dense_threshold * v
        if state == "sparse" and want_dense:
            dist = common.to_direction(graph, dist, S, G)
            changed = common.to_direction(graph, changed, S, G)
            state = "dense"
        elif state == "dense" and not want_dense:
            dist = common.to_direction(graph, dist, G, S)
            changed = common.to_direction(graph, changed, G, S)
            state = "sparse"

        if state == "sparse":
            cap = min(common.next_pow2(max(size, 8)), v_pad)
            ecap = min(common.next_pow2(max(nbrs, 8)), max(e, 8))
            fr = Frontier(mask=changed,
                          size=torch.tensor(size, dtype=torch.int32, device=dev),
                          neighbours_count=torch.tensor(
                              nbrs, dtype=torch.int32, device=dev),
                          direction=S)
            ids, valid = compact_ids(fr, cap)
            dist, changed, dsize, dnbrs = _partial_push_step(
                graph, weights.outgoing, dist, ids, valid, ecap)
        else:
            dist, changed, dsize = _partial_dense_step(
                graph, weights.incoming, dist, changed)
            dnbrs = torch.sum(torch.where(changed, outdeg_g, 0),
                              dtype=torch.int32)
        size, nbrs = common.read_scalars(dsize, dnbrs)
        iters += 1

    direction = S if state == "sparse" else G
    return VertexArray(values=dist, direction=direction), iters


def _sssp_partial_device(graph: VGLGraph, w_in, w_out, source_sorted_g,
                         id_cap: int, edge_cap: int,
                         max_iterations: int = 10_000,
                         trace: Optional[list] = None
                         ) -> tuple[torch.Tensor, int]:
    """Partial-active Bellman-Ford with its state on the device (reference
    sssp.py:147-223): (dist, changed) live in GATHER ordering; each sweep
    takes the smallest sparse-push tier that fits the changed set (routed to
    SCATTER ordering and back), else the dense pull restricted to changed
    sources. The host reads (size, nbrs) once per sweep.

    trace: if a list, each sweep appends ("push", id_cap, edge_cap) or
    ("dense",) for the branch it took."""
    with annotate("vgl.sssp"):
        outdeg_g = common.outdegrees_in(graph, G)
        zero = torch.zeros((), dtype=torch.int32, device=graph.device)
        # the source's start: indexing by its device id reads the id on
        # the host, and its degree is read
        with annotate("vgl.host_read"):
            dist, changed = _source_state(graph, source_sorted_g)
            nbrs = int(outdeg_g[source_sorted_g])
        tiers = common.capacity_tiers(id_cap, edge_cap)
        size, it = 1, 0
        while it < max_iterations and size > 0:
            tier = next((t for t in tiers if size < t[0] and nbrs < t[1]),
                        None)
            if trace is not None:
                trace.append(("push",) + tier if tier is not None
                             else ("dense",))
            with annotate("vgl.sssp.sweep.push" if tier is not None
                          else "vgl.sssp.sweep.dense"):
                if tier is not None:
                    dist_s = common.to_direction(graph, dist, G, S)
                    changed_s = common.to_direction(graph, changed, G, S)
                    fr = Frontier(mask=changed_s,
                                  size=torch.sum(changed_s,
                                                 dtype=torch.int32),
                                  neighbours_count=zero, direction=S)
                    ids, valid = compact_ids(fr, tier[0])
                    out_s = advance_push_sparse(
                        graph, ids, valid, tier[1], {"d": dist_s},
                        _relax_edge, "min", dist_s, edge_values=w_out,
                        direction=S)
                    out = common.to_direction(graph, out_s, S, G)
                else:
                    cand = advance_pull_value(
                        graph, dist, "min", edge_values=w_in,
                        weight_op="add", src_active=changed, direction=G)
                    out = torch.minimum(dist, cand)
                changed = out < dist
                dist = out
                size, nbrs = common.read_scalars(
                    torch.sum(changed, dtype=torch.int32),
                    torch.sum(torch.where(changed, outdeg_g, 0),
                              dtype=torch.int32))
            it += 1
    return dist, it


def _partial_caps(graph: VGLGraph, id_cap: int, edge_cap: int):
    return (min(id_cap, graph.v_pad),
            min(common.next_pow2(max(graph.e, 8)), edge_cap))


def vgl_dijkstra_partial_device(graph: VGLGraph, weights: EdgeArray,
                                source_vertex: int, id_cap: int = 1 << 12,
                                edge_cap: int = 1 << 16,
                                trace: Optional[list] = None
                                ) -> tuple[VertexArray, int]:
    """Work-efficient SSSP with device-resident state (reference
    vgl_dijkstra_partial_device); `trace` as in _sssp_partial_device."""
    sid = graph.incoming.orig_to_sorted[source_vertex].long()
    dist, iters = _sssp_partial_device(
        graph, weights.incoming, weights.outgoing, sid,
        *_partial_caps(graph, id_cap, edge_cap), trace=trace)
    return VertexArray(values=dist, direction=G), iters


# all-active beats partial-active below this edge count in the reference: one
# pull per sweep and no compaction or branch machinery; the port keeps the
# reference's threshold so that both pick the same variant
_AA_EDGE_THRESHOLD = 1 << 22


def vgl_dijkstra_multi(graph: VGLGraph, weights: EdgeArray, source_vertices,
                       id_cap: int = 1 << 12, edge_cap: int = 1 << 16,
                       all_active: Optional[bool] = None) -> VertexArray:
    """k independent SSSP runs one after another (the multi-root batch
    protocol, as bfs.vgl_bfs_device_multi). Picks all-active sweeps for
    small graphs (see _AA_EDGE_THRESHOLD) and the tiered partial-active work
    frontier for large ones; `all_active` overrides. Returns dist
    [k, v_pad] in GATHER ordering."""
    sids = graph.incoming.orig_to_sorted[torch.as_tensor(
        np.asarray(source_vertices, np.int64), device=graph.device)].long()
    if all_active is None:
        all_active = graph.e < _AA_EDGE_THRESHOLD
    if all_active:
        rows = [_all_active_run(graph, weights.incoming, s, 10_000)[0]
                for s in sids]
    else:
        caps = _partial_caps(graph, id_cap, edge_cap)
        rows = [_sssp_partial_device(graph, weights.incoming,
                                     weights.outgoing, s, *caps)[0]
                for s in sids]
    return VertexArray(values=torch.stack(rows), direction=G)


def seq_dijkstra(ec, source_vertex) -> np.ndarray:
    """Sequential oracle via SciPy Dijkstra; unreachable = +inf.
    source_vertex may be a list of vertices: then one row of distances per
    source, from one build of the matrix."""
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csg
    v = ec.vertices_count
    # parallel edges: keep the minimum weight (matches relaxation semantics);
    # csr_matrix would SUM duplicates, so dedupe first: one sort of the
    # (source, destination) keys, then the least weight of each run
    key = ec.src_ids.astype(np.int64) * v + ec.dst_ids
    order = np.argsort(key)
    key, w = key[order], ec.weights[order]
    first = np.ones(len(key), bool)
    first[1:] = key[1:] != key[:-1]
    at = np.flatnonzero(first)
    w = np.minimum.reduceat(w, at) if len(at) else w
    s, d = np.divmod(key[at], v)
    m = sp.csr_matrix((w, (s, d)), shape=(v, v))
    dist = csg.dijkstra(m, directed=True, indices=source_vertex)
    return dist.astype(np.float32)
