"""Advance: edge traversal — the framework's hot path (port of the fused
value-pull of vectorgraphlibrary_tpu/ops/advance.py).

A pull advance here is the reference's fused path, step for step:

1. the source vector goes to the source side's ordering (a vertex route),
2. it is broadcast over the source-side tiles (one message per edge slot),
3. the advance route moves the messages into destination slot order and the
   fused finish masks non-edge and self-loop slots to the combine identity
   (ops/route.py; one route-gather kernel launch on the card),
4. each destination row reduces its slots.

No step reads adjacency. `advance_cells` is the one pass that does, for
structural counts such as self-loops.

`advance_push_sparse` is the work-efficient push from a compacted frontier:
it expands the frontier's CSR rows into a flat edge list of static capacity
and scatter-combines one message per edge into the destination array (two
scatter-combine kernel launches on the card: the owner mark and the combine).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from ..config import TraversalDirection
from ..graph.device import DeviceDirectedGraph, VGLGraph
from . import monoid as M
from . import tiles as T
from .route import FinishSpec, apply_route


def _ext_tail(a: torch.Tensor, extra: int = 128) -> torch.Tensor:
    """Append `extra` zero slots so tile row slices can run past v_pad: a
    tail bucket's rows_pad may extend up to 127 rows beyond the last real
    row, and torch slicing would silently cut the slice short."""
    return torch.cat([a, a.new_zeros(extra)])


def _assemble(parts, covered: int, v_pad: int, ident: torch.Tensor, dtype,
              device) -> torch.Tensor:
    if covered < v_pad:
        parts.append(torch.full((v_pad - covered,), ident.item(), dtype=dtype,
                                device=device))
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def _broadcast_over_tiles(dg: DeviceDirectedGraph, src_vec: torch.Tensor,
                          n: int) -> torch.Tensor:
    """Per-edge-slot messages [n]: src_vec broadcast over the source-side
    tiles (huge chunks, then each bucket, row-major), zero-padded to n. Each
    tile's broadcast view is written once, straight into its slice."""
    out = torch.empty(n, dtype=src_vec.dtype, device=src_vec.device)
    offset = 0
    if dg.huge is not None:
        h = dg.huge
        seg_vals = src_vec[h.seg_ids.clamp(max=src_vec.shape[0] - 1).long()]
        size = h.n_chunks_pad * h.chunk_w
        out[:size].view(h.n_chunks_pad, h.chunk_w).copy_(
            seg_vals[:, None].expand(-1, h.chunk_w))
        offset = size
    src_ext = _ext_tail(src_vec)
    for b in dg.buckets:
        rows = src_ext[b.row_start:b.row_start + b.rows_pad]
        out[offset:offset + b.slots].view(b.rows_pad, b.width).copy_(
            T.broadcast_rows_flat(rows, b.width))
        offset += b.slots
    out[offset:].zero_()
    return out


def _reduce_dst_tiles(dst_dg: DeviceDirectedGraph, finished: torch.Tensor,
                      mon, dtype, v_pad_out: int,
                      ident: torch.Tensor) -> torch.Tensor:
    """Per-destination-row reduction over PRE-MASKED route output:
    `finished` already carries the monoid identity in every non-edge slot
    (the fused finish), so no adjacency tile is read."""
    parts = []
    covered = 0
    offset = 0
    if dst_dg.huge is not None:
        h = dst_dg.huge
        size = h.n_chunks_pad * h.chunk_w
        vals = finished[offset:offset + size].view(h.n_chunks_pad, h.chunk_w)
        offset += size
        chunk_red = mon.reduce_axis(vals, 1)
        parts.append(mon.segment_reduce(chunk_red, h.seg_lengths)[:h.n_rows])
        covered = h.n_rows
    for b in dst_dg.buckets:
        parts.append(T.group_reduce_flat(finished[offset:offset + b.slots],
                                         b.width, mon, b.rows))
        offset += b.slots
        covered = b.row_start + b.rows
    return _assemble(parts, covered, v_pad_out, ident, dtype, finished.device)


def _mask_value(mon, dtype):
    """Value that makes a source's messages act as the combine identity."""
    if mon.name in ("add", "or", "any01"):
        return 0
    if mon.name == "min":
        return torch.inf if dtype.is_floating_point else torch.iinfo(dtype).max
    if mon.name == "max":
        return -torch.inf if dtype.is_floating_point else torch.iinfo(dtype).min
    raise ValueError(mon.name)


def advance_pull_value(graph: VGLGraph,
                       src_vec: torch.Tensor,
                       combine,
                       exclude_self_loops: bool = False,
                       direction: TraversalDirection = TraversalDirection.GATHER,
                       out_dtype=None,
                       src_in_src_order: bool = False) -> torch.Tensor:
    """Restricted-form advance: per-edge message = the source's value, masked
    to the combine identity on non-edge slots and, optionally, self-loop
    slots; combined per destination. Covers PR (add, no self-loops), BFS
    bottom-up (or over bool), CC hook (min) and HITS (add).

    ``src_vec`` [v_pad] is in the traversal direction's ordering, the result
    [v_pad] too. src_in_src_order=True: ``src_vec`` is already in the SOURCE
    side's sorted ordering (SCATTER when direction=GATHER and vice versa), and
    the input's vertex route is skipped."""
    mon = M.get(combine)
    plan = graph.advance_route
    if direction == TraversalDirection.GATHER:
        src_dg, dst_dg = graph.outgoing, graph.incoming
        inverse = False
    else:
        src_dg, dst_dg = graph.incoming, graph.outgoing
        inverse = True
    is_bool = src_vec.dtype == torch.bool
    if is_bool:
        # bool pulls ride the route as int8 (1 B per slot)
        src_vec = src_vec.to(torch.int8)
        if mon.name == "or":
            mon = M.ANY01            # or over {0,1} == max, identity 0
    dtype = out_dtype or src_vec.dtype
    src_vec = src_vec.to(dtype)
    assert dtype.itemsize in (1, 4), dtype
    # bool-or runs as max over {0,1}: the mask/empty-row identity stays 0
    ident = 0 if is_bool else _mask_value(mon, dtype)

    if not src_in_src_order:
        # G -> S forward, S -> G inverse
        src_vec = apply_route(graph.vertex_route_s_from_g, src_vec,
                              inverse=inverse)
    msgs = _broadcast_over_tiles(src_dg, src_vec, plan.n)
    routed = apply_route(plan, msgs, inverse=inverse,
                         finish=FinishSpec(ident=ident,
                                           exclude_self_loops=exclude_self_loops))
    out = _reduce_dst_tiles(dst_dg, routed, mon, dtype, graph.v_pad,
                            torch.tensor(ident, dtype=dtype))
    if is_bool:
        # strictly-positive test, not a cast (reference advance.py:605-609)
        out = out > 0
    return out


def advance_cells(graph: VGLGraph,
                  cell_op,
                  combine,
                  direction: TraversalDirection = TraversalDirection.GATHER,
                  out_dtype=None) -> torch.Tensor:
    """Per-destination reduction over adjacency cells WITHOUT source values:
    msg = cell_op(src_ids, dst_ids, None). One pass over the tiles — for
    structural quantities (self-loop counts, filtered degrees)."""
    mon = M.get(combine)
    dg = graph.direction(direction)
    probe = cell_op(dg.col_idx[:1, None], dg.col_idx[:1, None], None)
    dtype = out_dtype or probe.dtype
    ident = mon.identity(dtype)
    dev = dg.col_idx.device
    parts = []
    covered = 0
    if dg.huge is not None:
        h = dg.huge
        dst_ids = h.seg_ids[:, None].expand(-1, h.chunk_w)
        msg = cell_op(h.adj, dst_ids, None).to(dtype)
        msg = torch.where(h.adj < dg.v_pad, msg, ident.to(dev))
        chunk_red = mon.reduce_axis(msg, 1)
        parts.append(mon.segment_reduce(chunk_red, h.seg_lengths)[:h.n_rows])
        covered = h.n_rows
    for b in dg.buckets:
        dst_ids = T.row_ids(b.row_start, b.rows_pad, b.width, dev)
        msg = cell_op(b.adj, dst_ids, None).to(dtype)
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
                        direction: TraversalDirection = TraversalDirection.SCATTER,
                        ) -> torch.Tensor:
    """Work-efficient push from a compacted frontier (reference
    advance.py:686-758; the analog of the C++ reference's sparse collective
    kernel `nec/advance_sparse.hpp:190-250`).

    Expands the frontier's rows into a flat edge list of static size
    ``edge_capacity``, makes one message per edge with
    ``edge_op(src_vals, {}, None)`` (src_vals[k]: [edge_capacity, 1]) and
    scatter-combines it into ``out`` ([v_pad], same ordering); returns the
    new array. Edges past the capacity (a frontier whose degree sum exceeds
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
    # drop (a clamp would steal the last slot's ownership).
    frontier_idx = torch.arange(cap, dtype=i32, device=dev)
    mark_slot = torch.where(frontier_valid & (degs > 0)
                            & (starts_local < edge_capacity),
                            starts_local, edge_capacity)
    owner_c = M.MAX.scatter_at(
        torch.full((edge_capacity,), -1, dtype=i32, device=dev), mark_slot,
        frontier_idx)
    owner_c = torch.cummax(owner_c, 0).values
    evalid = (pos < total) & (owner_c >= 0)
    owner_c = owner_c.clamp(0, cap - 1).long()

    e_slot = torch.where(evalid, pos + take(delta_c, owner_c), dg.e_pad)
    dsts = take(dg.col_idx, e_slot.long())
    sv = {k: take(a, owner_c)[:, None] for k, a in sv_cap.items()}
    msg = edge_op(sv, {}, None)[:, 0].to(out.dtype)

    scatter_idx = torch.where(evalid, dsts, out.shape[0])   # OOB -> dropped
    return mon.scatter_at(out, scatter_idx, msg, mode="drop")
