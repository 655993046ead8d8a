"""Device-resident graph containers (port of vectorgraphlibrary_tpu/graph/device.py).

``VGLGraph`` plays the role of the reference's ``VGL_Graph``: TWO directed
containers (outgoing + incoming), built by importing outgoing, transposing the
COO, and importing incoming (reference `vgl_graph.hpp:23-64`). Each direction
is a ``DeviceDirectedGraph``: degree-sorted CSR + padded tile buckets
(build.py) as int32 torch tensors on one device. Every array keeps the JAX
package's layout and values, except that a bucket is always stored row-major
(rows_pad, width) (ops/tiles.py says why that is the same slot order).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import VGLConfig, DEFAULT_CONFIG, TraversalDirection
from ..io.edges_container import EdgesContainer
from ..ops.route import RoutePlan, make_route_plan
from .build import build_directed_csr
from .route_build import build_advance_route


@dataclasses.dataclass(frozen=True)
class TileBucket:
    """A dense ELL rectangle of adjacency for a contiguous degree-sorted vertex
    range [row_start, row_start+rows), row-major (rows_pad, width)."""

    adj: torch.Tensor               # int32 [rows_pad, width], sentinel = v_pad
    width: int
    row_start: int
    rows: int
    rows_pad: int

    @property
    def slots(self) -> int:
        return self.rows_pad * self.width


# a huge row of more chunks than this is wide: the pull kernel gives it a
# block of threads, and every other huge row a warp (ops/advance.row_groups)
WIDE_ROW_CHUNKS = 4


@dataclasses.dataclass(frozen=True)
class HugeTile:
    """Row-split high-degree class: rows cut into chunks of chunk_w slots.
    The first n_wide_rows rows (degree-sorted) have more than
    WIDE_ROW_CHUNKS chunks."""

    adj: torch.Tensor               # int32 [n_chunks_pad, chunk_w]
    seg_ids: torch.Tensor           # int32 [n_chunks_pad], ascending row ids
    seg_lengths: torch.Tensor       # int64 [n_rows + 1]: chunks per row, then pad
    chunk_w: int
    n_rows: int
    n_chunks: int
    n_chunks_pad: int
    n_wide_rows: int


def huge_tile(adj: torch.Tensor, seg_ids: np.ndarray, chunk_w: int,
              n_rows: int, n_chunks: int, n_chunks_pad: int,
              device) -> HugeTile:
    """A HugeTile on `device` from its host arrays; the chunks per row and
    the count of wide rows come from the host's seg_ids."""
    lengths = np.bincount(seg_ids, minlength=n_rows + 1)
    return HugeTile(adj=adj, seg_ids=_i32(seg_ids, device),
                    seg_lengths=torch.from_numpy(
                        lengths.astype(np.int64)).to(device),
                    chunk_w=chunk_w, n_rows=n_rows, n_chunks=n_chunks,
                    n_chunks_pad=n_chunks_pad,
                    n_wide_rows=int((lengths[:n_rows] > WIDE_ROW_CHUNKS).sum()))


@dataclasses.dataclass(frozen=True)
class DeviceDirectedGraph:
    """One traversal direction: degree-sorted CSR + tiles + renumber maps."""

    row_ptr: torch.Tensor           # int32 [v_pad+1]
    col_idx: torch.Tensor           # int32 [e_pad]
    degrees: torch.Tensor           # int32 [v_pad]
    sorted_to_orig: torch.Tensor    # int32 [v_pad]
    orig_to_sorted: torch.Tensor    # int32 [v_pad]
    buckets: Tuple[TileBucket, ...]
    huge: Optional[HugeTile]
    v: int
    v_pad: int
    e: int
    e_pad: int


def _i32(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)


def _to_device_directed(h, device) -> DeviceDirectedGraph:
    """Host CSR (graph/build.py HostDirectedCSR of either package) -> device.
    The per-slot CSR edge indices (eidx) stay on the host: they only lay out
    per-tile copies of edge values, which the port does not keep
    (graph/edges.py)."""
    buckets = tuple(
        TileBucket(adj=_i32(b.adj, device), width=b.width,
                   row_start=b.row_start, rows=b.rows, rows_pad=b.rows_pad)
        for b in h.buckets)
    huge = None
    if h.huge is not None:
        hh = h.huge
        huge = huge_tile(_i32(hh.adj, device), hh.seg_ids, hh.chunk_w,
                         hh.n_rows, hh.n_chunks, hh.n_chunks_pad, device)
    return DeviceDirectedGraph(
        row_ptr=_i32(h.row_ptr, device), col_idx=_i32(h.col_idx, device),
        degrees=_i32(h.degrees, device),
        sorted_to_orig=_i32(h.sorted_to_orig, device),
        orig_to_sorted=_i32(h.orig_to_sorted, device),
        buckets=buckets, huge=huge, v=h.vertices_count, v_pad=h.vertices_pad,
        e=h.edges_count, e_pad=h.edges_pad)


@dataclasses.dataclass(frozen=True)
class VGLGraph:
    """User-facing graph: outgoing + incoming directed containers
    (reference vgl_graph.h:7-80). SCATTER traverses outgoing, GATHER incoming.

    ``advance_route`` moves outgoing-tile slots to incoming-tile slots:
    forward = pull over incoming; inverse = pull over outgoing. The vertex
    routes change orderings: forward gives the left ordering's values from the
    right ordering's (scatter_vals = apply_route(s_from_g, gather_vals)),
    inverse the reverse."""

    outgoing: DeviceDirectedGraph
    incoming: DeviceDirectedGraph
    advance_route: RoutePlan
    vertex_route_s_from_g: RoutePlan
    vertex_route_s_from_o: RoutePlan
    vertex_route_g_from_o: RoutePlan
    v: int
    v_pad: int
    e: int
    out_slots: int
    in_slots: int

    @property
    def device(self) -> torch.device:
        return self.outgoing.degrees.device

    def direction(self, d: TraversalDirection) -> DeviceDirectedGraph:
        if d == TraversalDirection.SCATTER:
            return self.outgoing
        if d == TraversalDirection.GATHER:
            return self.incoming
        raise ValueError("ORIGINAL has no directed container")


def from_host(h_out, h_in, selfloop_edges: np.ndarray, v: int, e: int,
              device="cuda") -> VGLGraph:
    """VGLGraph from the two host CSRs (graph/build.py HostDirectedCSR; the
    JAX package's, from its import_graph(ec, _host_out=...), works as well).
    selfloop_edges: bool [e] over COO edge ids."""
    device = torch.device(device)
    out = _to_device_directed(h_out, device)
    inc = _to_device_directed(h_in, device)
    assert out.v_pad == inc.v_pad
    route, out_slots, in_slots = build_advance_route(
        h_out, h_in, selfloop_edges=selfloop_edges, device=device)
    vpad = h_out.vertices_pad
    # scatter_vals[i] = gather_vals[g_of_s[i]]: gather-space id of the vertex
    # whose scatter-space id is i (identity on padding slots)
    g_of_s = np.arange(vpad, dtype=np.int64)
    g_of_s[:v] = h_in.orig_to_sorted[h_out.sorted_to_orig[:v]]
    # ORIGINAL -> sorted orderings: sorted_vals[i] = orig_vals[s2o[i]]
    o_of_s = np.arange(vpad, dtype=np.int64)
    o_of_s[:v] = h_out.sorted_to_orig[:v]
    o_of_g = np.arange(vpad, dtype=np.int64)
    o_of_g[:v] = h_in.sorted_to_orig[:v]
    return VGLGraph(outgoing=out, incoming=inc, advance_route=route,
                    vertex_route_s_from_g=make_route_plan(g_of_s, device=device),
                    vertex_route_s_from_o=make_route_plan(o_of_s, device=device),
                    vertex_route_g_from_o=make_route_plan(o_of_g, device=device),
                    v=v, v_pad=out.v_pad, e=e, out_slots=out_slots,
                    in_slots=in_slots)


def import_graph(ec: EdgesContainer, cfg: VGLConfig = DEFAULT_CONFIG,
                 device="cuda", _host_out: Optional[list] = None) -> VGLGraph:
    """COO → VGLGraph (both directions, tiles, the flagged advance route and
    the three vertex routes), reference vgl_graph.hpp:60-64. _host_out: a
    list that receives the two host CSRs (outgoing, incoming), which
    graph.edges.build_edge_array_from_host needs to lay out edge values."""
    h_out = build_directed_csr(ec.src_ids, ec.dst_ids, ec.vertices_count, cfg)
    h_in = build_directed_csr(ec.dst_ids, ec.src_ids, ec.vertices_count, cfg)
    if _host_out is not None:
        _host_out.extend([h_out, h_in])
    return from_host(h_out, h_in, ec.src_ids == ec.dst_ids, ec.vertices_count,
                     ec.edges_count, device)
