"""Advance: edge traversal — the framework's hot path (port of the fused
value-pull, the general pull and the sparse push of
vectorgraphlibrary_tpu/ops/advance.py).

The reference's fused pull broadcasts the source vector over the source
tiles, moves one message per edge slot through the advance route (a Beneš
network, because per-element gathers were its chip's slow operation), masks
non-edge and self-loop slots and reduces each destination's tile rows. That
whole chain computes, over the direction's own CSR,

    out[v] = combine over in-row k of v of wop(x[col_idx[k]], w[k])
                                                       (self-loops optional)

which is what `advance_pull_value` runs here: one launch of the CSR pull
kernel (ops/cuda/pull_reduce.py), after one vertex route when the input is in
the source side's ordering. The edge values w come from an EdgeArray's copy
in CSR slot order (graph/edges.py). `advance_cells` keeps the tile pass, for
structural counts such as self-loops.

`advance_pull` is the general form: a user edge op over named source and
destination arrays and the edge values. The reference runs it over its tiles
(TILE_CSR, CSR_VG), as an edge-parallel sorted segment reduction (CSR) or as
a scatter-combine (EDGES_LIST); here one CSR form serves every format: a
gather per edge, the edge op on [E, 1] tensors, inactive sources' messages
set to the identity, and one launch of the CSR kernel's segment-reduce entry
(ops/cuda/pull_reduce.segment_reduce). `advance_pull_fast` and
`advance_pull_routed` are the reference's two faster ways to run it, and
names for the same form here.

`advance_push_sparse` is the work-efficient push from a compacted frontier
for any edge op: it expands the frontier's CSR rows into a flat edge list of
static capacity and scatter-combines one message per edge (made from the
source's values and the edge's value) into the destination array (two
scatter-combine kernel launches on the card: the owner mark and the
combine). `advance_push_sparse_const`, its case of one
constant int32 message (the BFS top-down step), is one expand-and-scatter
kernel launch (ops/cuda/push_expand.py).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..config import TraversalDirection
from ..graph.device import DeviceDirectedGraph, VGLGraph
from ..graph.edges import DirectedEdgeValues
from . import monoid as M
from . import tiles as T
from .cuda.pull_reduce import Plan, make_plan, pull_reduce, segment_reduce
from .cuda.push_expand import push_expand
from .route import apply_route


def _assemble(parts, covered: int, v_pad: int, ident: torch.Tensor, dtype,
              device) -> torch.Tensor:
    if covered < v_pad:
        parts.append(torch.full((v_pad - covered,), ident.item(), dtype=dtype,
                                device=device))
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def pull_plan(dg: DeviceDirectedGraph) -> Plan:
    """The pull kernel's schedule over one direction's CSR
    (ops/cuda/pull_reduce.make_plan), made at the first pull and kept with
    the graph."""
    return dg.derived("pull_plan", lambda: make_plan(dg.row_ptr))


def advance_pull_value(graph: VGLGraph,
                       src_vec: torch.Tensor,
                       combine,
                       edge_values: Optional[DirectedEdgeValues] = None,
                       weight_op: Optional[str] = None,
                       exclude_self_loops: bool = False,
                       src_active: Optional[torch.Tensor] = None,
                       direction: TraversalDirection = TraversalDirection.GATHER,
                       out_dtype=None,
                       src_in_src_order: bool = False) -> torch.Tensor:
    """Restricted-form advance: per-edge message = ``weight_op(src_value,
    edge_value)`` (or the source's value itself), optionally not on
    self-loops, combined per destination. Covers PR (add, no self-loops), BFS
    bottom-up (or over bool), CC hook (min), HITS (add), the SSSP pull (min
    of value + w) and SSWP (max of min(value, w)).

    ``src_vec`` [v_pad] is in the traversal direction's ordering, the result
    [v_pad] too; ``edge_values`` are the direction's (read only with a
    weight_op in add, min, max, mul), and the result has the type
    result_type(src_vec, edge values). src_in_src_order=True: ``src_vec``
    (and ``src_active``) is in the SOURCE side's sorted ordering (SCATTER
    when direction=GATHER and vice versa), and one vertex route brings it
    into the direction's ordering first.

    ``src_active`` (bool [v_pad], same ordering as src_vec) restricts the
    messages to those from active sources, as the reference's fused route
    does: an inactive source's value is replaced BEFORE the pull by the
    combine's identity, which must stay the identity through the weight op
    (inf + w = inf, min(-inf, w) = -inf), so only min or max combines or a
    mul weight op take it with weights."""
    mon = M.get(combine)
    dg = graph.direction(direction)
    weights = None
    if weight_op is not None:
        if edge_values is None:
            raise ValueError("advance_pull_value: weight_op needs edge_values")
        weights = edge_values.flat
        # absorbing-value src_active masking must survive the weight combine
        assert src_active is None or mon.name in ("min", "max") \
            or weight_op == "mul", (mon.name, weight_op)
    is_bool = src_vec.dtype == torch.bool
    if is_bool:
        # bool pulls run as int8 (1 B per vertex read)
        src_vec = src_vec.to(torch.int8)
        if mon.name == "or":
            mon = M.ANY01            # or over {0,1} == max, identity 0
    dtype = out_dtype or (torch.result_type(src_vec, weights)
                          if weights is not None else src_vec.dtype)
    src_vec = src_vec.to(dtype)
    if src_active is not None:
        # bool "or" runs as max over {0,1}: its identity stays 0
        ident = torch.zeros((), dtype=dtype) if is_bool else mon.identity(dtype)
        src_vec = torch.where(src_active, src_vec, ident.to(src_vec.device))
    if src_in_src_order:
        # S -> G is the inverse of s_from_g, G -> S its forward
        src_vec = apply_route(graph.vertex_route_s_from_g, src_vec,
                              inverse=direction == TraversalDirection.GATHER)
    if weights is not None and weights.dtype != dtype:
        weights = weights.to(dtype)
    out = pull_reduce(dg.row_ptr, dg.col_idx, src_vec, mon.name,
                      exclude_self_loops, pull_plan(dg), weights=weights,
                      weight_op=weight_op)
    if is_bool:
        # strictly-positive test, not a cast (reference advance.py:605-609)
        out = out > 0
    return out


def _slot_rows(dg: DeviceDirectedGraph) -> torch.Tensor:
    """Owning row (the direction's sorted vertex id) of each of the CSR's e
    real slots."""
    return torch.repeat_interleave(
        torch.arange(dg.v_pad, dtype=torch.int32, device=dg.col_idx.device),
        dg.degrees.long(), output_size=dg.e)


def advance_pull(graph: VGLGraph,
                 src_arrays: Dict[str, torch.Tensor],
                 edge_op: Callable,
                 combine,
                 dst_arrays: Optional[Dict[str, torch.Tensor]] = None,
                 edge_values: Optional[DirectedEdgeValues] = None,
                 src_active: Optional[torch.Tensor] = None,
                 direction: TraversalDirection = TraversalDirection.GATHER,
                 out_dtype=None) -> torch.Tensor:
    """Aggregate over the incoming edges of every vertex (the reference's
    gather-mode advance, advance.py:119-197, and its CSR form :82-117).

    ``src_arrays`` and ``dst_arrays`` hold [v_pad] values per vertex in the
    traversal direction's ordering; ``edge_op(src_vals, dst_vals, w)`` gets
    the edges' [E, 1] slices of them (src_vals[k]: the source's value,
    dst_vals[k]: the destination's, w: ``edge_values``'s, the direction's, or
    None) and returns [E, 1] messages, combined per destination. The result
    is [v_pad] in that ordering, of out_dtype or the messages' type, with
    the identity for a vertex without messages. ``src_active`` (bool [v_pad])
    keeps only the messages of active sources: a mask after the edge op,
    exact for any op (advance_pull_value instead puts an identity into the
    source vector before its pull). One segment-reduce launch on the card;
    float sums differ from the reference's tiled ones only in order."""
    mon = M.get(combine)
    dg = graph.direction(direction)
    cols = dg.col_idx[:dg.e].long()
    sv = {k: a[cols][:, None] for k, a in src_arrays.items()}
    dv = {}
    if dst_arrays:
        rows = _slot_rows(dg).long()
        dv = {k: a[rows][:, None] for k, a in dst_arrays.items()}
    w = None if edge_values is None else edge_values.flat[:dg.e, None]
    msg = edge_op(sv, dv, w)[:, 0]
    if out_dtype is not None:
        msg = msg.to(out_dtype)
    is_bool = msg.dtype == torch.bool
    if is_bool:
        # bool messages reduce as int8 (or and max as any01 over {0, 1})
        msg = msg.to(torch.int8)
        if mon.name in ("or", "max"):
            mon = M.ANY01
    if src_active is not None:
        msg = torch.where(src_active[cols], msg,
                          mon.identity(msg.dtype).to(msg.device))
    out = segment_reduce(dg.row_ptr, msg.contiguous(), mon.name,
                         pull_plan(dg))
    return out.to(torch.bool) if is_bool else out


# the reference's routed, gather-free way to run advance_pull
# (advance.py:338-435): the same function and the same src_active mask
advance_pull_fast = advance_pull


def advance_pull_routed(graph: VGLGraph,
                        src_vec: torch.Tensor,
                        edge_op: Callable,
                        combine,
                        edge_values: Optional[DirectedEdgeValues] = None,
                        src_active: Optional[torch.Tensor] = None,
                        direction: TraversalDirection
                        = TraversalDirection.GATHER,
                        out_dtype=None) -> torch.Tensor:
    """The reference's gather-free advance (advance.py:227-317) as the CSR
    form: ``src_vec`` (and ``src_active``) in the SOURCE side's sorted
    ordering (SCATTER when direction=GATHER and vice versa), the result in
    the direction's. ``edge_op(vals, src_ids, dst_ids, w)`` gets [E, 1]
    tensors: the sources' values, their ids and the destinations' ids in the
    direction's ordering, and the edge values. An inactive source's value is
    replaced by the combine's identity BEFORE the edge op, as there (the
    algorithms' ops keep it: linear in vals for add, monotone for min/max)."""
    mon = M.get(combine)
    if src_active is not None:
        ident = 0 if mon.name in ("add", "or", "any01") \
            else mon.identity(src_vec.dtype).item()
        src_vec = torch.where(src_active, src_vec,
                              torch.tensor(ident, dtype=src_vec.dtype,
                                           device=src_vec.device))
    # S -> G is the inverse of s_from_g, G -> S its forward
    src_vec = apply_route(graph.vertex_route_s_from_g, src_vec,
                          inverse=direction == TraversalDirection.GATHER)
    ids = torch.arange(graph.v_pad, dtype=torch.int32, device=src_vec.device)
    return advance_pull(
        graph, {"x": src_vec, "id": ids},
        lambda s, d, w: edge_op(s["x"], s["id"], d["id"], w), combine,
        dst_arrays={"id": ids}, edge_values=edge_values, direction=direction,
        out_dtype=out_dtype)


def _cell_values(dg: DeviceDirectedGraph, flat: torch.Tensor, adj: torch.Tensor,
                 rows: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """The edge value of every tile slot, from ``flat`` (CSR slot order):
    slot j of a tile row that starts at CSR slot ``first`` of its vertex row
    holds flat[row_ptr[row] + first + j]; the tile's padding slots (adj at
    v_pad) take 0, the JAX package's default pad value for its tile copies.
    rows, first: int64 [tile rows]."""
    ext = torch.cat([flat, flat.new_zeros(1)])
    pos = (dg.row_ptr.long()[rows] + first)[:, None] + torch.arange(
        adj.shape[1], device=adj.device)
    return ext[torch.where(adj < dg.v_pad, pos, flat.shape[0])]


def advance_cells(graph: VGLGraph,
                  cell_op,
                  combine,
                  edge_values: Optional[DirectedEdgeValues] = None,
                  direction: TraversalDirection = TraversalDirection.GATHER,
                  out_dtype=None) -> torch.Tensor:
    """Per-destination reduction over adjacency cells WITHOUT source values:
    msg = cell_op(src_ids, dst_ids, w), w the slot's value from
    ``edge_values`` (the direction's, in CSR slot order) or None. One pass
    over the tiles, for every format (the reference takes its CSR and
    edge-list formats over the CSR slots: the same cells) — for structural
    quantities (self-loop counts, filtered degrees)."""
    mon = M.get(combine)
    dg = graph.direction(direction)
    flat = None if edge_values is None else edge_values.flat
    probe = cell_op(dg.col_idx[:1, None], dg.col_idx[:1, None],
                    None if flat is None else flat[:1, None])
    dtype = out_dtype or probe.dtype
    ident = mon.identity(dtype)
    dev = dg.col_idx.device
    parts = []
    covered = 0
    if dg.huge is not None:
        h = dg.huge
        dst_ids = h.seg_ids[:, None].expand(-1, h.chunk_w)
        w = None
        if flat is not None:
            # chunk c is chunk c - (first chunk of its row) of that row;
            # padding chunks (past the last row) are all padding slots
            rows = h.seg_ids.long().clamp(max=h.n_rows - 1)
            first_chunk = torch.cumsum(h.seg_lengths, 0) - h.seg_lengths
            k = torch.arange(h.n_chunks_pad, device=dev) - first_chunk[rows]
            w = _cell_values(dg, flat, h.adj, rows, k * h.chunk_w)
        msg = cell_op(h.adj, dst_ids, w).to(dtype)
        msg = torch.where(h.adj < dg.v_pad, msg, ident.to(dev))
        chunk_red = mon.reduce_axis(msg, 1)
        parts.append(mon.segment_reduce(chunk_red, h.seg_lengths)[:h.n_rows])
        covered = h.n_rows
    for b in dg.buckets:
        dst_ids = T.row_ids(b.row_start, b.rows_pad, b.width, dev)
        w = None
        if flat is not None:
            rows = dst_ids[:, 0].long().clamp(max=dg.v_pad - 1)
            w = _cell_values(dg, flat, b.adj, rows, torch.zeros_like(rows))
        msg = cell_op(b.adj, dst_ids, w).to(dtype)
        msg = torch.where(b.adj < dg.v_pad, msg, ident.to(dev))
        parts.append(mon.reduce_axis(msg, 1)[:b.rows])
        covered = b.row_start + b.rows
    return _assemble(parts, covered, graph.v_pad, ident, dtype, dev)


def advance_push_sparse(graph: VGLGraph,
                        frontier_ids: torch.Tensor,     # int32 [cap], pad = v_pad
                        frontier_valid: torch.Tensor,   # bool [cap]
                        edge_capacity: int,
                        src_arrays: Dict[str, torch.Tensor],
                        edge_op: Callable,
                        combine,
                        out: torch.Tensor,
                        edge_values: Optional[DirectedEdgeValues] = None,
                        direction: TraversalDirection = TraversalDirection.SCATTER,
                        ) -> torch.Tensor:
    """Work-efficient push from a compacted frontier (reference
    advance.py:686-758; the analog of the C++ reference's sparse collective
    kernel `nec/advance_sparse.hpp:190-250`).

    Expands the frontier's rows into a flat edge list of static size
    ``edge_capacity``, makes one message per edge with
    ``edge_op(src_vals, {}, w)`` (src_vals[k] and w: [edge_capacity, 1]; w
    the edge's value from ``edge_values``, the direction's, or None) and
    scatter-combines it into ``out`` ([v_pad], same ordering); returns the
    new array. A slot that holds no edge reads some value of the array (the
    padding's, clipped) and its message is dropped. Edges past the capacity (a frontier whose degree sum exceeds
    it) are dropped. Nothing is read back to the host."""
    mon = M.get(combine)
    dg = graph.direction(direction)
    cap = frontier_ids.shape[0]
    dev = out.device
    i32 = torch.int32
    ids = frontier_ids.long()

    def take(a, index):
        """jnp.take(a, index, mode="clip")"""
        return a[index.clamp(0, a.shape[0] - 1)]

    degs = torch.where(frontier_valid, take(dg.degrees, ids), 0)
    row_start_c = take(dg.row_ptr, ids)
    ends = torch.cumsum(degs, 0, dtype=i32)                     # inclusive
    starts_local = ends - degs
    # per-frontier-row constant: e_slot = pos + delta[owner]
    delta_c = row_start_c - starts_local
    sv_cap = {k: take(a, ids) for k, a in src_arrays.items()}
    total = ends[-1] if cap > 0 else torch.zeros((), dtype=i32, device=dev)

    pos = torch.arange(edge_capacity, dtype=i32, device=dev)
    # owner row of each flat edge slot: each nonempty row's index is marked
    # at its start offset, then a running max fills the run. Zero-degree rows
    # share start offsets and must not mark; rows starting past the capacity
    # drop (a clamp would steal the last slot's ownership). The marks go
    # into the target made here, in place.
    frontier_idx = torch.arange(cap, dtype=i32, device=dev)
    mark_slot = torch.where(frontier_valid & (degs > 0)
                            & (starts_local < edge_capacity),
                            starts_local, edge_capacity)
    owner_c = M.MAX.scatter_at_(
        torch.full((edge_capacity,), -1, dtype=i32, device=dev), mark_slot,
        frontier_idx)
    owner_c = torch.cummax(owner_c, 0).values
    evalid = (pos < total) & (owner_c >= 0)
    owner_c = owner_c.clamp(0, cap - 1).long()

    e_slot = torch.where(evalid, pos + take(delta_c, owner_c), dg.e_pad)
    dsts = take(dg.col_idx, e_slot.long())
    sv = {k: take(a, owner_c)[:, None] for k, a in sv_cap.items()}
    w = (None if edge_values is None
         else take(edge_values.flat, e_slot.long())[:, None])
    msg = edge_op(sv, {}, w)[:, 0].to(out.dtype)

    scatter_idx = torch.where(evalid, dsts, out.shape[0])   # OOB -> dropped
    return mon.scatter_at(out, scatter_idx, msg, mode="drop")


def advance_push_sparse_const(graph: VGLGraph,
                              frontier_ids: torch.Tensor,  # int32 [cap]
                              frontier_valid: torch.Tensor,  # bool [cap]
                              edge_capacity: int,
                              msg: int,
                              combine,
                              out: torch.Tensor,
                              direction: TraversalDirection
                              = TraversalDirection.SCATTER) -> torch.Tensor:
    """`advance_push_sparse` for the edge op ``lambda s, d, w: msg`` (one
    int32 constant per edge) combined by min, max or or into the int32
    array ``out``; returns the new array. One push_expand launch on the
    card; edges past the capacity drop, as there."""
    dg = graph.direction(direction)
    return push_expand(out, dg.row_ptr, dg.col_idx, dg.degrees, frontier_ids,
                       frontier_valid, edge_capacity, msg, M.get(combine).name)
