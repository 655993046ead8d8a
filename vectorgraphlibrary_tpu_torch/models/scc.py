"""Strongly connected components: trim + forward-backward (port of
vectorgraphlibrary_tpu/models/scc.py).

Capability match for the reference SCC (`algorithms/scc/scc.h:21-60`,
`scc.hpp:55-130`): iterative in/out-degree trimming followed by
forward-backward pivot decomposition; the sequential oracle is SciPy's
strong connected_components.

A trim step is two int32 add pulls of the active mask (in-degree over
incoming, out-degree over outgoing edges; two CSR pull kernel launches and
four vertex routes on the card); a flood hop is one bool or pull (the int8
any01 pull) and two vertex routes. The reference's three `lax.while_loop`s
(the trim fixpoint and the two floods of a pivot round) are host loops here
with the same state and condition, reading one scalar per step, so labels
equal the JAX package's exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import TraversalDirection
from ..graph.device import VGLGraph
from ..graph.vertices import VertexArray
from ..ops.advance import advance_pull_value
from . import common

S, G, O = (TraversalDirection.SCATTER, TraversalDirection.GATHER,
           TraversalDirection.ORIGINAL)


def _active_degree_step(graph: VGLGraph, active_o: torch.Tensor):
    """(in-degree, out-degree) restricted to active vertices, ORIGINAL order."""
    act_g = common.to_direction(graph, active_o, O, G)
    indeg = advance_pull_value(graph, act_g.to(torch.int32), "add",
                               direction=G)
    indeg_o = common.to_direction(graph, indeg, G, O)
    act_s = common.to_direction(graph, active_o, O, S)
    outdeg = advance_pull_value(graph, act_s.to(torch.int32), "add",
                                direction=S)
    outdeg_o = common.to_direction(graph, outdeg, S, O)
    return indeg_o, outdeg_o


def _trim_step(graph: VGLGraph, labels_o: torch.Tensor, real: torch.Tensor):
    """One trim round: active vertices with zero active in- or out-degree
    become their own (singleton) SCC. Returns (labels, count trimmed) with
    the count as a 0-d device tensor."""
    active = (labels_o == -1) & real
    indeg_o, outdeg_o = _active_degree_step(graph, active)
    trim = active & ((indeg_o == 0) | (outdeg_o == 0))
    ids = torch.arange(labels_o.shape[0], dtype=torch.int32,
                       device=labels_o.device)
    return torch.where(trim, ids, labels_o), torch.sum(trim, dtype=torch.int32)


def _reach_step(graph: VGLGraph, reach_o: torch.Tensor,
                active_o: torch.Tensor, forward: bool) -> torch.Tensor:
    """Expand reachability one hop along outgoing (forward) or incoming
    edges, restricted to the active subgraph; ORIGINAL ordering."""
    d = S if forward else G
    via = advance_pull_value(graph, common.to_direction(graph, reach_o, O, d),
                             "or", direction=d)
    return reach_o | (common.to_direction(graph, via, d, O) & active_o)


def _trim_fixpoint(graph: VGLGraph, labels_o: torch.Tensor,
                   real: torch.Tensor, trace=None) -> torch.Tensor:
    """Trim until a round trims nothing: the reference's while_loop over
    (labels, ntrim) from ntrim = 1. `trace`, a list, receives ("trim",
    count) per round."""
    ntrim = 1
    while ntrim > 0:
        labels_o, dn = _trim_step(graph, labels_o, real)
        ntrim = int(dn)
        if trace is not None:
            trace.append(("trim", ntrim))
    return labels_o


def _fb_pivot_round(graph: VGLGraph, labels_o: torch.Tensor,
                    real: torch.Tensor, trace=None):
    """One pivot round: pick the first unlabeled vertex, flood forward and
    backward to fixpoint, carve the SCC, re-trim the remainder. Returns
    (labels, remaining unlabeled count as an int). `trace` receives
    ("flood", hops) per flood and the trim rounds."""
    ids = torch.arange(graph.v_pad, dtype=torch.int32, device=graph.device)
    active = (labels_o == -1) & real
    has = bool(torch.any(active))
    seed = torch.argmax(active.to(torch.int32)).to(torch.int32)

    def flood(forward: bool) -> torch.Tensor:
        reach = (ids == seed) & has
        grew, hops = has, 0
        while grew:
            reach2 = _reach_step(graph, reach, active, forward)
            grew = bool(torch.any(reach2 != reach))
            reach, hops = reach2, hops + 1
        if trace is not None:
            trace.append(("flood", hops))
        return reach

    fwd = flood(True)
    bwd = flood(False)
    scc = (fwd & bwd & active) | ((ids == seed) & has)
    labels = torch.where(scc, seed, labels_o)
    labels = _trim_fixpoint(graph, labels, real, trace)
    return labels, int(torch.sum((labels == -1) & real, dtype=torch.int32))


def vgl_forward_backward(graph: VGLGraph, max_pivots: int = 1_000_000,
                         trace=None) -> VertexArray:
    """Labels in ORIGINAL ordering: a vertex's label is the original id of
    its component's pivot, or its own id when trimmed (padding: v).
    `trace`, a list, receives the steps in order: ("trim", count) per trim
    round, ("flood", hops) per flood, ("pivot", remaining) per pivot
    round."""
    real = torch.arange(graph.v_pad, device=graph.device) < graph.v
    labels = torch.where(real, -1, graph.v).to(torch.int32)
    labels = _trim_fixpoint(graph, labels, real, trace)
    pivots = 0
    while pivots < max_pivots:
        labels, remaining = _fb_pivot_round(graph, labels, real, trace)
        pivots += 1
        if trace is not None:
            trace.append(("pivot", remaining))
        if remaining == 0:
            break
    return VertexArray(values=labels, direction=O)


def seq_scc(ec) -> np.ndarray:
    """Tarjan-equivalent oracle (reference seq_scc.hpp) via SciPy."""
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csg
    v = ec.vertices_count
    # f32 ones: int8 ones, as in the reference, wrap negative where more
    # than 127 parallel edges sum (scipy then warns of negative weights)
    a = sp.csr_matrix((np.ones(ec.edges_count, np.float32),
                       (ec.src_ids, ec.dst_ids)), shape=(v, v))
    _, labels = csg.connected_components(a, directed=True, connection="strong")
    return labels.astype(np.int32)
