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

from ..config import GraphFormat, VGLConfig, DEFAULT_CONFIG, TraversalDirection
from ..io.edges_container import EdgesContainer
from ..ops.route import RoutePlan, make_route_plan
from ..runtime.profiling import annotate
from .route_build import build_advance_route


@dataclasses.dataclass(frozen=True)
class TileBucket:
    """A dense ELL rectangle of adjacency for a contiguous degree-sorted vertex
    range [row_start, row_start+rows), row-major (rows_pad, width)."""

    adj: Optional[torch.Tensor]     # int32 [rows_pad, width], sentinel =
    width: int                      # v_pad; None on a slim shard
    row_start: int
    rows: int
    rows_pad: int

    @property
    def slots(self) -> int:
        return self.rows_pad * self.width


@dataclasses.dataclass(frozen=True)
class HugeTile:
    """Row-split high-degree class: rows cut into chunks of chunk_w slots."""

    adj: Optional[torch.Tensor]     # int32 [n_chunks_pad, chunk_w]; None
    seg_ids: torch.Tensor           # int32 [n_chunks_pad], ascending row ids
    seg_lengths: torch.Tensor       # int64 [n_rows + 1]: chunks per row, then pad
    chunk_w: int
    n_rows: int
    n_chunks: int
    n_chunks_pad: int


def huge_tile(adj: torch.Tensor, seg_ids: np.ndarray, chunk_w: int,
              n_rows: int, n_chunks: int, n_chunks_pad: int,
              device) -> HugeTile:
    """A HugeTile on `device` from its host arrays; the chunks per row come
    from the host's seg_ids."""
    lengths = np.bincount(seg_ids, minlength=n_rows + 1)
    return HugeTile(adj=adj, seg_ids=_i32(seg_ids, device),
                    seg_lengths=torch.from_numpy(
                        lengths.astype(np.int64)).to(device),
                    chunk_w=chunk_w, n_rows=n_rows, n_chunks=n_chunks,
                    n_chunks_pad=n_chunks_pad)


@dataclasses.dataclass(frozen=True)
class DeviceDirectedGraph:
    """One traversal direction: degree-sorted CSR + tiles + renumber maps."""

    row_ptr: torch.Tensor           # int32 [v_pad+1]
    col_idx: torch.Tensor           # int32 [e_pad]
    degrees: torch.Tensor           # int32 [v_pad]
    # int32 [v_pad] each; None on a slim shard (the vertex routes hold
    # the same orderings)
    sorted_to_orig: Optional[torch.Tensor]
    orig_to_sorted: Optional[torch.Tensor]
    buckets: Tuple[TileBucket, ...]
    huge: Optional[HugeTile]
    v: int
    v_pad: int
    e: int
    e_pad: int

    def derived(self, key, build):
        """A device structure derived from this direction (such as the pull
        kernel's schedule), made by build() at the first call with `key`
        and kept with it. It is no field: graphs compare, save and load
        without it."""
        cache = self.__dict__.setdefault("_derived", {})
        if key not in cache:
            cache[key] = build()
        return cache[key]


def _i32(a: np.ndarray, device) -> torch.Tensor:
    """a as int32 on `device`; raises ValueError where a holds a value
    past int32 (a CSR of 2^31 arcs or more), which a cast would wrap."""
    a = np.asarray(a)
    if a.dtype != np.int32 and a.size and (
            a.max() >= 2**31 or a.min() < -2**31):
        raise ValueError(f"values up to {int(a.max()):,} do not fit the "
                         f"device's int32 (a CSR takes fewer than 2^31 "
                         f"arcs)")
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)


def synchronize(device) -> None:
    """Wait for the work queued on `device` (a CUDA device; nothing to wait
    for on the CPU): so that a kept span holds the device work it queued."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _to_device_directed(h, device, slim: bool = False
                        ) -> DeviceDirectedGraph:
    """Host CSR (graph/build.py HostDirectedCSR of either package) -> device.
    The per-slot CSR edge indices (eidx) stay on the host: they only lay out
    per-tile copies of edge values, which the port does not keep
    (graph/edges.py). slim: as parallel/shard_build.slim_value_pull leaves
    a direction, without uploading what it drops (the tiles' adjacency,
    the renumber maps, col_idx past the CSR's edges)."""
    def opt(a):
        return None if slim else _i32(a, device)
    buckets = tuple(
        TileBucket(adj=opt(b.adj), width=b.width,
                   row_start=b.row_start, rows=b.rows, rows_pad=b.rows_pad)
        for b in h.buckets)
    huge = None
    if h.huge is not None:
        hh = h.huge
        huge = huge_tile(opt(hh.adj), hh.seg_ids, hh.chunk_w,
                         hh.n_rows, hh.n_chunks, hh.n_chunks_pad, device)
    col_idx = h.col_idx[:h.edges_count] if slim else h.col_idx
    return DeviceDirectedGraph(
        row_ptr=_i32(h.row_ptr, device), col_idx=_i32(col_idx, device),
        degrees=_i32(h.degrees, device),
        sorted_to_orig=opt(h.sorted_to_orig),
        orig_to_sorted=opt(h.orig_to_sorted),
        buckets=buckets, huge=huge, v=h.vertices_count, v_pad=h.vertices_pad,
        e=h.edges_count, e_pad=h.edges_pad)


@dataclasses.dataclass(frozen=True)
class VGLGraph:
    """User-facing graph: outgoing + incoming directed containers
    (reference vgl_graph.h:7-80). SCATTER traverses outgoing, GATHER incoming.

    ``advance_route`` moves outgoing-tile slots to incoming-tile slots:
    forward = pull over incoming; inverse = pull over outgoing (None when
    the graph was imported with build_route=False; no advance reads it, and
    persistence needs it). The vertex
    routes change orderings: forward gives the left ordering's values from the
    right ordering's (scatter_vals = apply_route(s_from_g, gather_vals)),
    inverse the reverse.

    ``graph_format`` is the format the graph was imported as. Every format
    keeps the same degree-sorted CSR and tiles here, since every advance of
    the port runs over the CSR; only TILE_CSR builds the advance route, as
    in the reference."""

    outgoing: DeviceDirectedGraph
    incoming: DeviceDirectedGraph
    advance_route: Optional[RoutePlan]
    vertex_route_s_from_g: RoutePlan
    vertex_route_s_from_o: RoutePlan
    vertex_route_g_from_o: RoutePlan
    v: int
    v_pad: int
    e: int
    out_slots: int
    in_slots: int
    graph_format: GraphFormat = GraphFormat.TILE_CSR
    # a shard's incoming route slot of each incoming CSR slot, int32 [e]:
    # the order in which the JAX package keeps a shard's edge weights
    # (parallel/sharded.slot_hash_weight_fn); None for a graph
    in_route_slots: Optional[torch.Tensor] = None
    # a shard without its advance route and tiles
    # (parallel/shard_build.slim_value_pull)
    slim: bool = False

    @property
    def device(self) -> torch.device:
        return self.outgoing.degrees.device

    def derived(self, key, build):
        """A device structure derived from this graph (such as a transposed
        CSR), made by build() at the first call with `key` and kept with the
        graph. It is no field: graphs compare, save and load without it."""
        cache = self.__dict__.setdefault("_derived", {})
        if key not in cache:
            cache[key] = build()
        return cache[key]

    def direction(self, d: TraversalDirection) -> DeviceDirectedGraph:
        if d == TraversalDirection.SCATTER:
            return self.outgoing
        if d == TraversalDirection.GATHER:
            return self.incoming
        raise ValueError("ORIGINAL has no directed container")


def from_host(h_out, h_in, selfloop_edges: np.ndarray, v: int, e: int,
              device="cuda", build_route: bool = True,
              graph_format: GraphFormat = GraphFormat.TILE_CSR) -> VGLGraph:
    """VGLGraph from the two host CSRs (graph/build.py HostDirectedCSR; the
    JAX package's, from its import_graph(ec, _host_out=...), works as well).
    selfloop_edges: bool [e] over COO edge ids. build_route=False leaves
    out the advance route (advance_route None, out_slots = in_slots = 0, as
    in the reference); the vertex routes are built either way."""
    device = torch.device(device)
    with annotate("vgl.import.to_device", keep=True):
        out = _to_device_directed(h_out, device)
        inc = _to_device_directed(h_in, device)
    return _with_routes(out, inc, h_out, h_in, selfloop_edges, v, e, device,
                        build_route, graph_format)


def _with_routes(out: DeviceDirectedGraph, inc: DeviceDirectedGraph, h_out,
                 h_in, selfloop_edges: Optional[np.ndarray], v: int, e: int,
                 device, build_route: bool,
                 graph_format: GraphFormat) -> VGLGraph:
    """The VGLGraph of both directions on the device, with its routes.
    h_out, h_in: the directions' host CSRs (graph/build.py) or, from the
    device build, graph/build_torch.DeviceDirectedCSR."""
    from .build_torch import DeviceDirectedCSR, host_csr
    assert out.v_pad == inc.v_pad
    on_device = isinstance(h_out, DeviceDirectedCSR)
    route, out_slots, in_slots = None, 0, 0
    if build_route:
        with annotate("vgl.import.advance_route", keep=True):
            hosts = ((host_csr(h_out), host_csr(h_in)) if on_device
                     else (h_out, h_in))
            route, out_slots, in_slots = build_advance_route(
                *hosts, selfloop_edges=selfloop_edges, device=device)
    with annotate("vgl.import.vertex_routes", keep=True):
        maps = (h_out.sorted_to_orig, h_in.orig_to_sorted,
                h_in.sorted_to_orig)
        if on_device:
            maps = torch.stack(maps).cpu().numpy()     # one copy down
        s2o_out, o2s_in, s2o_in = maps
        vpad = out.v_pad
        # scatter_vals[i] = gather_vals[g_of_s[i]]: gather-space id of the
        # vertex whose scatter-space id is i (identity on padding slots)
        g_of_s = np.arange(vpad, dtype=np.int64)
        g_of_s[:v] = o2s_in[s2o_out[:v]]
        # ORIGINAL -> sorted orderings: sorted_vals[i] = orig_vals[s2o[i]]
        o_of_s = np.arange(vpad, dtype=np.int64)
        o_of_s[:v] = s2o_out[:v]
        o_of_g = np.arange(vpad, dtype=np.int64)
        o_of_g[:v] = s2o_in[:v]
        s_from_g, s_from_o, g_from_o = (make_route_plan(a, device=device)
                                        for a in (g_of_s, o_of_s, o_of_g))
    return VGLGraph(outgoing=out, incoming=inc, advance_route=route,
                    vertex_route_s_from_g=s_from_g,
                    vertex_route_s_from_o=s_from_o,
                    vertex_route_g_from_o=g_from_o,
                    v=v, v_pad=out.v_pad, e=e, out_slots=out_slots,
                    in_slots=in_slots, graph_format=graph_format)


def import_graph(ec: EdgesContainer, cfg: VGLConfig = DEFAULT_CONFIG,
                 graph_format: GraphFormat = GraphFormat.TILE_CSR,
                 device="cuda", _host_out: Optional[list] = None,
                 build_route: bool = True,
                 keep_edge_slots: Optional[bool] = None) -> VGLGraph:
    """COO → VGLGraph (both directions, tiles, the flagged advance route and
    the three vertex routes), reference vgl_graph.hpp:60-64. Each direction
    is built on `device` (graph/build_torch.build_directed_csr_torch) from
    the edge ids, uploaded once: the same tensors as graph/build.py's host
    build uploaded by from_host. _host_out: a list that receives the two
    directions' records (graph/build_torch.DeviceDirectedCSR: outgoing,
    incoming), whose edge_perm, on the device,
    graph.edges.build_edge_array_from_host needs to lay out edge values.
    build_route=False skips only the advance route, as
    models/tc.reachability does for its condensed graph.

    graph_format (reference device.py:184-247): only TILE_CSR builds the
    advance route; every format keeps the CSR and tiles (VGLGraph says
    why). keep_edge_slots is accepted for the reference's signature and
    stores nothing: the reference keeps per-slot edge indices on the device
    to lay out its tile copies of edge values, and the port keeps no such
    copies (graph/edges.py); edge_perm (_host_out) lays out values in CSR
    slot order. Spans: _csr_on_device."""
    del keep_edge_slots
    device = torch.device(device)
    v = ec.vertices_count
    route = build_route and graph_format == GraphFormat.TILE_CSR
    with annotate("vgl.import", keep=True):
        with annotate("vgl.import.to_device", keep=True):
            src = torch.from_numpy(np.ascontiguousarray(ec.src_ids)).to(device)
            dst = torch.from_numpy(np.ascontiguousarray(ec.dst_ids)).to(device)
            synchronize(device)
        d_out = _csr_on_device(src, dst, v, cfg, device)
        d_in = _csr_on_device(dst, src, v, cfg, device)
        del src, dst
        if _host_out is not None:
            _host_out.extend([d_out, d_in])
        return _with_routes(d_out.graph, d_in.graph, d_out, d_in,
                            ec.src_ids == ec.dst_ids if route else None, v,
                            ec.edges_count, device, route, graph_format)


def _csr_on_device(src: torch.Tensor, dst: torch.Tensor, v: int,
                   cfg: VGLConfig, device: torch.device):
    """One direction built on the device (graph/build_torch) in a kept
    vgl.import.csr span, its device work in a kept vgl.import.csr.device
    span; the outer span ends after a device synchronize, so that the
    build's queued work stays inside it."""
    from .build_torch import build_directed_csr_torch
    with annotate("vgl.import.csr", keep=True):
        with annotate("vgl.import.csr.device", keep=True):
            built = build_directed_csr_torch(src, dst, v, cfg)
        synchronize(device)
    return built
