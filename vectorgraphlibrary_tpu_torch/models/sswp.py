"""SSWP — single-source widest paths (port of
vectorgraphlibrary_tpu/models/sswp.py).

Capability match for the reference SSWP (`algorithms/sswp/widest_paths.h:20-30`,
`.hpp`): Bellman-Ford where the relaxation is
`cap[v] = max(cap[v], min(cap[u], w))` (bottleneck/maximum-capacity path).
Same design as SSSP: one pull over incoming edges with max-combine and weight
op min per sweep (one CSR pull kernel launch), to the fixpoint. The
reference's `lax.while_loop` is a host loop here that reads one flag per
sweep, with the same state and condition, so the sweep count is the same.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import TraversalDirection
from ..graph.device import VGLGraph
from ..graph.edges import EdgeArray
from ..graph.vertices import VertexArray
from ..ops.advance import advance_pull_value
from . import common

G = TraversalDirection.GATHER


def _sswp_run(graph: VGLGraph, weights_in, source_sorted,
              max_iterations: int) -> tuple[torch.Tensor, int]:
    def relax(cap):
        cand = advance_pull_value(graph, cap, "max", edge_values=weights_in,
                                  weight_op="min", direction=G)
        return torch.maximum(cap, cand)

    cap0 = torch.zeros(graph.v_pad, dtype=torch.float32, device=graph.device)
    cap0[source_sorted] = torch.inf
    return common.fixpoint(relax, cap0, max_iterations)


def vgl_widest_paths(graph: VGLGraph, weights: EdgeArray, source_vertex: int,
                     max_iterations: int = 10_000) -> tuple[VertexArray, int]:
    sid = graph.incoming.orig_to_sorted[source_vertex].long()
    cap, iters = _sswp_run(graph, weights.incoming, sid, max_iterations)
    return VertexArray(values=cap, direction=G), iters


def seq_widest_paths(ec, source_vertex: int) -> np.ndarray:
    """Oracle: the JAX package's label-correcting fixpoint (cap[v] = max(cap[v],
    min(cap[u], w)) over all edges per pass, in fp64) with the same result (a
    max has one answer in any order), but each pass takes the
    per-destination max with np.maximum.reduceat over the edges sorted by
    destination once, in place of np.maximum.at, which is slow on large
    graphs."""
    v = ec.vertices_count
    order = np.argsort(ec.dst_ids, kind="stable")
    s, d = ec.src_ids[order], ec.dst_ids[order]
    w = ec.weights[order].astype(np.float64)
    cap = np.zeros(v, np.float64)
    cap[source_vertex] = np.inf
    if len(d) == 0:
        return cap.astype(np.float32)
    starts = np.flatnonzero(np.r_[True, d[1:] != d[:-1]])
    dsts = d[starts]
    for _ in range(v):
        cand = np.zeros(v, np.float64)
        cand[dsts] = np.maximum.reduceat(np.minimum(cap[s], w), starts)
        new = np.maximum(cap, cand)
        if np.array_equal(new, cap):
            break
        cap = new
    return cap.astype(np.float32)
