"""Maximum flow — Edmonds-Karp (BFS-augmenting Ford-Fulkerson) (port of
vectorgraphlibrary_tpu/models/mf.py).

Capability match for the reference MF (`algorithms/mf/mf.h:10-38`,
`mf.hpp`). The residual structure is a graph of 2e arcs (each edge forward,
then each edge backward), imported once; only the arcs' residual capacities
change. The JAX package keeps them in its advance route's slot order and runs
the whole algorithm as one device program; the port keeps them in the
incoming CSR's slot order and runs the reference's loops on the host:

- per augmentation, a level-synchronous BFS over arcs with residual above
  _EPS: per level one weighted pull_reduce launch (ops/advance.
  advance_pull_value: the min over in-arcs from the current level of the
  arc's slot id, or _BIG where its residual is spent) and one read of two
  flags (did the frontier grow, was the sink reached);
- the path walk on the host, from the sink back to the source along the
  parent arcs, after one copy of the parent array;
- the residual update as two indexed updates over the path's slots (minus
  the bottleneck on the path's arcs, plus it on their reverse arcs).

A vertex's parent arc is the lowest CSR slot id among its candidates, not
the reference's lowest route slot id, so augmenting paths may differ; the
flow value is the same (it is the maximum).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import TraversalDirection
from ..graph.device import VGLGraph, import_graph
from ..graph.edges import DirectedEdgeValues
from ..io.edges_container import EdgesContainer
from ..ops.advance import advance_pull, advance_pull_value

G = TraversalDirection.GATHER
_BIG = 2**30
_EPS = 1e-6
_INF = 2**31 - 1


class Residual(NamedTuple):
    """The residual structure, in the incoming CSR's slot order."""

    graph: VGLGraph
    res0: torch.Tensor          # f32 [e_pad]: capacity, 0 on reverse arcs
    rev_slot: torch.Tensor      # int32 [2e]: the reverse arc's slot
    src_of_slot: np.ndarray     # the arc's source, GATHER ids (col_idx)
    arc_of_slot: np.ndarray     # int64 [2e]: the arc (edge_perm)


def build_residual(ec: EdgesContainer, device="cuda") -> Residual:
    """The Residual of ec's 2e arcs, built once per container and device and
    kept with the container (EdgesContainer.derived): benchmark apps run
    many rounds over one container, and vgl_mf_bfs_levels reads the same
    structure."""
    return ec.derived(("mf_residual", str(torch.device(device))),
                      lambda: _build_residual(ec, device))


def _build_residual(ec: EdgesContainer, device) -> Residual:
    e, e2 = ec.edges_count, 2 * ec.edges_count
    # arc a < e is edge a, arc e + a its reverse; no advance route
    src2 = np.concatenate([ec.src_ids, ec.dst_ids]).astype(np.int32)
    dst2 = np.concatenate([ec.dst_ids, ec.src_ids]).astype(np.int32)
    host = []
    g2 = import_graph(EdgesContainer(src2, dst2, ec.vertices_count),
                      device=device, _host_out=host, build_route=False)
    arc = host[1].edge_perm[:e2].cpu().numpy()       # CSR slot -> arc
    slot = np.empty(e2, np.int64)
    slot[arc] = np.arange(e2)
    rev_slot = slot[np.where(arc < e, arc + e, arc - e)]
    res0 = np.zeros(g2.incoming.e_pad, np.float32)
    fwd = arc < e
    res0[:e2][fwd] = ec.weights[arc[fwd]]
    return Residual(g2, torch.from_numpy(res0).to(g2.device),
                    torch.from_numpy(rev_slot.astype(np.int32)).to(g2.device),
                    g2.incoming.col_idx.cpu().numpy(), arc)


def _ek_run(g2: VGLGraph, res0: torch.Tensor, rev_slot: torch.Tensor,
            src_of_slot: np.ndarray, sid: int, tid: int,
            max_augmentations: int, max_path: int, trace=None):
    """Edmonds-Karp on the residual graph between GATHER ids sid != tid;
    returns (flow as a 0-d f32 tensor, augmentations). trace, a list,
    receives one (BFS levels, path arcs) pair per BFS, path arcs 0 for the
    last one when it did not reach the sink."""
    dev = res0.device
    v_pad = g2.v_pad
    res = res0.clone()
    iota = torch.arange(res.shape[0], dtype=torch.int32, device=dev)
    zeros = torch.zeros(v_pad, dtype=torch.int32, device=dev)
    total = torch.zeros((), dtype=torch.float32, device=dev)
    aug = 0
    while aug < max_augmentations:
        ev = DirectedEdgeValues(flat=torch.where(res > _EPS, iota, _BIG))
        levels = torch.full((v_pad,), _INF, dtype=torch.int32, device=dev)
        levels[sid] = 1
        parent = torch.full((v_pad,), _BIG, dtype=torch.int32, device=dev)
        cur, reached, n_levels = 1, False, 0
        while not reached:
            cand = advance_pull_value(g2, zeros, "min", edge_values=ev,
                                      weight_op="max",
                                      src_active=levels == cur, direction=G)
            newly = (levels == _INF) & (cand < _BIG)
            levels = torch.where(newly, cur + 1, levels)
            parent = torch.where(newly, cand, parent)
            cur += 1
            n_levels += 1
            grew, reached = torch.stack(
                [newly.any(), levels[tid] != _INF]).tolist()
            if not grew:
                break
        aug += 1
        path, u = [], tid
        if reached:
            par = parent.cpu().numpy()
            while u != sid and len(path) < max_path:
                s = int(par[u])
                path.append(s)
                u = int(src_of_slot[s])
        if trace is not None:
            trace.append((n_levels, len(path)))
        if u != sid:        # the sink not reached, or a path past max_path
            break
        slots = torch.tensor(path, dtype=torch.long, device=dev)
        bottleneck = res[slots].min()
        res[slots] -= bottleneck
        res[rev_slot[slots].long()] += bottleneck
        total = total + bottleneck
    return total, aug


def vgl_ford_fulkerson(ec: EdgesContainer, graph: Optional[VGLGraph],
                       source: int, sink: int,
                       max_augmentations: int = 10_000,
                       max_path: Optional[int] = None, device=None,
                       trace=None) -> float:
    """Edmonds-Karp max flow source→sink (original ids); returns the flow
    value. `graph` is unused (kept for the reference-shaped API) but for
    its device, which `device` overrides (default cuda). The residual-arc
    structure is built once per container (build_residual).

    max_path bounds the augmenting-path walk; it defaults to the vertex
    count, which a BFS-shortest path cannot exceed. A smaller cap, like
    max_augmentations, stops the algorithm early. trace: as _ek_run's."""
    if device is None:
        device = graph.device if graph is not None else "cuda"
    if max_path is None:
        max_path = max(int(ec.vertices_count), 16)
    g2, res0, rev_slot, src_of_slot, _ = build_residual(ec, device)
    o2s = g2.incoming.orig_to_sorted
    sid, tid = torch.stack([o2s[source], o2s[sink]]).tolist()
    if sid == tid:
        # the reference's path walk never starts and adds an infinite
        # bottleneck on every augmentation
        return float("inf") if max_augmentations > 0 else 0.0
    total, _ = _ek_run(g2, res0, rev_slot, src_of_slot, sid, tid,
                       max_augmentations, max_path, trace)
    return float(total)


def vgl_mf_bfs_levels(ec: EdgesContainer, graph: Optional[VGLGraph],
                      flow: np.ndarray, source: int,
                      device=None) -> np.ndarray:
    """Residual-BFS levels for a given flow per edge (the reference's
    standalone mf_bfs surface): int32 [v] in original ids, 1 at the source,
    int32 max where unreached. One general advance (advance_pull, a min of
    the arc id over arcs with residual above _EPS from the current level)
    per level. `graph`: as in vgl_ford_fulkerson. The residual graph is
    build_residual's, kept on the container (the reference imports it anew
    on every call)."""
    if device is None:
        device = graph.device if graph is not None else "cuda"
    v, e2 = ec.vertices_count, 2 * ec.edges_count
    g2, _, _, _, arc = build_residual(ec, device)
    res = np.concatenate([(ec.weights - flow).astype(np.float32),
                          np.asarray(flow).astype(np.float32)])
    w_flat = np.full(g2.incoming.e_pad, _BIG, np.int32)
    w_flat[:e2] = np.where(res[arc] > _EPS, arc, _BIG)
    ev = DirectedEdgeValues(flat=torch.from_numpy(w_flat).to(g2.device))
    o2s = g2.incoming.orig_to_sorted
    levels = torch.full((g2.v_pad,), _INF, dtype=torch.int32,
                        device=g2.device)
    levels[o2s[source].long()] = 1
    cur = 1
    while True:
        cand = advance_pull(g2, {}, lambda sv, dv, w: w, "min",
                            edge_values=ev, src_active=levels == cur,
                            direction=G)
        newly = (levels == _INF) & (cand < _BIG)
        if not bool(newly.any()):
            break
        levels = torch.where(newly, cur + 1, levels)
        cur += 1
    return levels[o2s.long()].cpu().numpy()[:v]


def seq_ford_fulkerson(ec: EdgesContainer, source: int, sink: int) -> float:
    """Oracle via SciPy maximum_flow (integer capacities)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import maximum_flow
    v = ec.vertices_count
    capi = np.maximum(ec.weights.astype(np.int64), 1)
    # dedupe parallel edges by summing capacities
    a = sp.csr_matrix((capi, (ec.src_ids, ec.dst_ids)), shape=(v, v))
    a = sp.csr_matrix(a)                      # sums duplicates
    return float(maximum_flow(a, source, sink).flow_value)
