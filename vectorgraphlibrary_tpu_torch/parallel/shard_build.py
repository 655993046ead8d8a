"""Sharded flagship container: destination-partitioned TILE_CSR (port of
vectorgraphlibrary_tpu/parallel/shard_build.py).

Each shard owns the destinations d with d % S == s and holds their in-edges
as a full tiled and routed subgraph over the whole vertex space, so the
single-card advance runs on every shard unchanged. Another partition (the
large tier's destination hash, apps/build_scale25.py) plans its shards
with plan_parts and builds each with build_shard_edges. Every shard is built
against the unified TileLayout (graph/build.layout_of, unify_layouts): the
elementwise max of the shards' natural layouts. The reference needs that to
stack the shards into one pytree; here the shards stay a list, and the
unified layout gives every shard file the reference's shapes, so the two
packages read each other's sharded graphs (graph/persistence.py). A
shard's VGLGraph.e is e_pad, as in the reference, and each direction's e
stays its CSR's edge count, as the port's general advance reads it; the
reference stores e_pad there too, and the shard files do (persistence).

Execution chooses between one rank per shard (sharded.make_*_sharded,
merged by an all-reduce) and a loop over the shards on one card
(sharded.*_sharded_scan), whose peak working set is one shard's pull.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import VGLConfig, DEFAULT_CONFIG, GraphFormat
from ..graph.build import (HostDirectedCSR, build_directed_csr, layout_of,
                           unify_layouts)
from ..graph.device import (DeviceDirectedGraph, VGLGraph,
                            _to_device_directed)
from ..graph.edges import EdgeArray, build_edge_array_from_host
from ..graph.route_build import build_advance_route, in_route_slots
from ..io.edges_container import EdgesContainer
from ..ops.route import make_route_plan


def _next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << int(np.ceil(np.log2(x)))


def _complete_perm(partial: np.ndarray) -> np.ndarray:
    """Fill the -1 entries of a partial permutation bijectively with the
    unused values."""
    n = len(partial)
    used = np.zeros(n, bool)
    used[partial[partial >= 0]] = True
    out = partial.copy()
    holes = np.flatnonzero(partial < 0)
    out[holes] = np.flatnonzero(~used)[:len(holes)]
    return out


def _vertex_perm(h_left: HostDirectedCSR, h_right: HostDirectedCSR,
                 v: int, v_pad: int) -> np.ndarray:
    """perm with left_vals[i] = right_vals[perm[i]] for real vertices; gaps
    completed bijectively (their values are never read: masked rows)."""
    p = np.full(v_pad, -1, np.int64)
    real = h_left.sorted_to_orig < v
    p[real] = h_right.orig_to_sorted[h_left.sorted_to_orig[real]]
    return _complete_perm(p)


def _from_orig_perm(h: HostDirectedCSR, v: int) -> np.ndarray:
    """sorted_vals[i] = orig_vals[perm[i]]; gap rows completed bijectively."""
    return _complete_perm(np.where(h.sorted_to_orig < v, h.sorted_to_orig,
                                   -1).astype(np.int64))


@dataclasses.dataclass(frozen=True)
class ShardedTileGraph:
    """S TILE_CSR shards with one layout, and the edges of each shard."""

    shards: Tuple[VGLGraph, ...]
    edges_per_shard: Tuple[int, ...]
    n_shards: int = 1
    v: int = 0
    v_pad: int = 0
    e: int = 0

    def shard(self, s: int) -> VGLGraph:
        """Shard s. (The reference's take_shard strips the leading axis of
        a stacked pytree inside shard_map; the shards here are not stacked,
        so it has no counterpart.)"""
        return self.shards[s]

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    def derived(self, key, build):
        """A device structure derived from this graph (such as PageRank's
        degree constants), made by build() at the first call with `key`
        and kept with the graph. It is no field: graphs compare, save and
        load without it."""
        cache = self.__dict__.setdefault("_derived", {})
        if key not in cache:
            cache[key] = build()
        return cache[key]


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """What every shard's build shares: the partition and the unified
    layouts and paddings (reference shard_build.py:102-117)."""

    n_shards: int
    shard_id: Optional[np.ndarray]   # int [e]: the edge's shard, or None
    edges_per_shard: Tuple[int, ...]
    layout_out: object
    layout_in: object
    v_pad: int
    e_pad: int


def plan_parts(parts, v: int, cfg: VGLConfig = DEFAULT_CONFIG,
               shard_id: Optional[np.ndarray] = None) -> ShardPlan:
    """The plan of shards given by their edges, parts = [(src, dst), ...]
    in shard order, whatever the partition (import_sharded's dst % S,
    apps/build_scale25.py's multiplicative hash): the shards' natural
    layouts unified, v_pad and the unified e_pad. Host only: one degree
    count per shard and direction. shard_id: the partition itself, which
    build_shard reads; None where the caller keeps each shard's edges
    (build_shard_edges)."""
    louts, lins, counts = [], [], []
    for src, dst in parts:
        louts.append(layout_of(np.bincount(src, minlength=v), cfg))
        lins.append(layout_of(np.bincount(dst, minlength=v), cfg))
        counts.append(int(len(src)))
    l_out, l_in = unify_layouts(louts), unify_layouts(lins)
    v_pad = max(_next_pow2(max(l_out.total_rows, l_in.total_rows, v)), 1024)
    e_pad = max(8 * ((max(counts) + 7) // 8), 8)
    return ShardPlan(n_shards=len(counts), shard_id=shard_id,
                     edges_per_shard=tuple(counts), layout_out=l_out,
                     layout_in=l_in, v_pad=v_pad, e_pad=e_pad)


def _plan_shards(ec: EdgesContainer, n_shards: int,
                 cfg: VGLConfig = DEFAULT_CONFIG) -> ShardPlan:
    """Partition by destination modulo S (a contiguous range would put the
    power-law hubs of low ids in shard 0, and the unified layout would then
    size every shard like shard 0) and unify the shards' natural layouts."""
    shard_id = ec.dst_ids % n_shards
    parts = ((ec.src_ids[m], ec.dst_ids[m])
             for m in (shard_id == s for s in range(n_shards)))
    return plan_parts(parts, ec.vertices_count, cfg, shard_id)


def _pad_edges(h: HostDirectedCSR, e_pad: int) -> None:
    """Grow a shard's edge arrays to the unified e_pad."""
    if h.edges_pad == e_pad:
        return
    assert e_pad > h.edges_pad
    grow = e_pad - h.edges_pad
    h.col_idx = np.concatenate(
        [h.col_idx, np.full(grow, h.vertices_pad, np.int32)])
    h.edge_perm = np.concatenate(
        [h.edge_perm, np.full(grow, e_pad, np.int64)])
    h.edges_pad = e_pad


def _tile_slots(h: HostDirectedCSR) -> int:
    """The slots of a direction's tiles (huge chunks, then the buckets):
    the advance route's out_slots or in_slots (route_build.slot_map's
    total)."""
    huge = 0 if h.huge is None else h.huge.n_chunks_pad * h.huge.chunk_w
    return huge + sum(b.rows_pad * b.width for b in h.buckets)


def _build_shard(ec: EdgesContainer, plan: ShardPlan, s: int,
                 cfg: VGLConfig, device,
                 slim: bool = False) -> Tuple[VGLGraph, tuple]:
    """Shard s on `device` and its two host CSRs; a slim shard builds no
    advance route and uploads none of what slim_value_pull drops."""
    m = plan.shard_id == s
    return build_shard_edges(ec.src_ids[m], ec.dst_ids[m], ec.vertices_count,
                             plan, cfg, device, slim)


def build_shard_edges(src: np.ndarray, dst: np.ndarray, v: int,
                      plan: ShardPlan, cfg: VGLConfig = DEFAULT_CONFIG,
                      device="cpu", slim: bool = False
                      ) -> Tuple[VGLGraph, tuple]:
    """The shard that holds the edges (src, dst) of a plan's partition, on
    `device`, and its two host CSRs (h_out, h_in); h_in.edge_perm maps each
    incoming CSR slot to its edge's index in (src, dst). slim as in
    import_sharded."""
    device = torch.device(device)
    h_out = build_directed_csr(src, dst, v, cfg, layout=plan.layout_out,
                               v_pad=plan.v_pad)
    h_in = build_directed_csr(dst, src, v, cfg, layout=plan.layout_in,
                              v_pad=plan.v_pad)
    _pad_edges(h_out, plan.e_pad)
    _pad_edges(h_in, plan.e_pad)
    if slim:
        route = None
        out_slots, in_slots = _tile_slots(h_out), _tile_slots(h_in)
    else:
        route, out_slots, in_slots = build_advance_route(
            h_out, h_in, selfloop_edges=src == dst, device=device)
    g = VGLGraph(
        outgoing=_to_device_directed(h_out, device, slim),
        incoming=_to_device_directed(h_in, device, slim),
        advance_route=route,
        vertex_route_s_from_g=make_route_plan(
            _vertex_perm(h_out, h_in, v, plan.v_pad), device=device),
        vertex_route_s_from_o=make_route_plan(_from_orig_perm(h_out, v),
                                              device=device),
        vertex_route_g_from_o=make_route_plan(_from_orig_perm(h_in, v),
                                              device=device),
        v=v, v_pad=plan.v_pad, e=plan.e_pad, out_slots=out_slots,
        in_slots=in_slots, graph_format=GraphFormat.SHARDED_CSR,
        in_route_slots=in_route_slots(h_in.row_ptr, h_in.buckets, h_in.huge,
                                      device), slim=slim)
    return g, (h_out, h_in)


def slim_value_pull(g: VGLGraph) -> VGLGraph:
    """The shard without what the port's shard pull never reads: the
    advance route (about 10 B per route slot: two int32 gather indices and
    two flag bytes), the tiles' adjacency (bucket and huge `adj`, 4 B per
    tile slot), the two renumber maps per direction, whose orderings the
    vertex routes also hold, and each col_idx's padding past the shard's
    own edges to the unified e_pad (the dst % S split leaves the largest
    shard with most of the edges, and every shard padded to it). It keeps
    each direction's CSR (row_ptr, col_idx, degrees), the tiles' metadata
    and huge seg_ids, the three vertex routes and in_route_slots, so every
    scan and rank runner, the weight layouts and the sharded GraphSAGE run
    on it.

    This is the reverse of the JAX package's slim shard
    (vectorgraphlibrary_tpu/parallel/shard_build.py:159-176), which keeps
    the advance route and strips the CSR: its chip pulls through the route
    and its tiles. The port's pull reads each direction's CSR (one kernel
    launch over row_ptr and col_idx, ops/advance.advance_pull_value), so
    the CSR is what stays here and the route is what goes."""
    def strip(dg: DeviceDirectedGraph) -> DeviceDirectedGraph:
        return dataclasses.replace(
            dg, col_idx=dg.col_idx[:dg.e].clone(), sorted_to_orig=None,
            orig_to_sorted=None,
            buckets=tuple(dataclasses.replace(b, adj=None)
                          for b in dg.buckets),
            huge=(None if dg.huge is None
                  else dataclasses.replace(dg.huge, adj=None)))
    return dataclasses.replace(g, outgoing=strip(g.outgoing),
                               incoming=strip(g.incoming), advance_route=None,
                               slim=True)


def import_shard(ec: EdgesContainer, n_shards: int, s: int,
                 cfg: VGLConfig = DEFAULT_CONFIG, device="cuda",
                 _host_out: Optional[list] = None,
                 keep_edge_slots: Optional[bool] = None,
                 slim: bool = False) -> VGLGraph:
    """Shard s of import_sharded(ec, n_shards) alone, built against the
    same unified layouts, so that each rank builds only its own. _host_out
    receives (h_out, h_in). keep_edge_slots is taken for the reference's
    signature and stores nothing (graph/device.import_graph says why);
    slim as in import_sharded."""
    del keep_edge_slots
    g, hosts = _build_shard(ec, _plan_shards(ec, n_shards, cfg), s, cfg,
                            torch.device(device), slim)
    if _host_out is not None:
        _host_out.append(hosts)
    return g


def import_sharded(ec: EdgesContainer, n_shards: int,
                   cfg: VGLConfig = DEFAULT_CONFIG, device="cuda",
                   _host_out: Optional[list] = None,
                   keep_edge_slots: Optional[bool] = None,
                   slim: bool = False) -> ShardedTileGraph:
    """Partition COO by destination, build every shard against the unified
    layouts. _host_out receives [(h_out, h_in), ...] per shard, which
    shard_edge_values needs to lay out edge values. keep_edge_slots as in
    import_shard. slim=True: every shard as slim_value_pull leaves it (the
    out-of-memory scale path), without building the advance route."""
    del keep_edge_slots
    device = torch.device(device)
    plan = _plan_shards(ec, n_shards, cfg)
    shards = []
    for s in range(n_shards):
        g, hosts = _build_shard(ec, plan, s, cfg, device, slim)
        shards.append(g)
        if _host_out is not None:
            _host_out.append(hosts)
    return ShardedTileGraph(shards=tuple(shards),
                            edges_per_shard=plan.edges_per_shard,
                            n_shards=n_shards, v=ec.vertices_count,
                            v_pad=plan.v_pad, e=ec.edges_count)


def estimated_shard_slots(ec: EdgesContainer, n_shards: int,
                          cfg: VGLConfig = DEFAULT_CONFIG) -> int:
    """Max per-shard route size n (pow2 slot count) WITHOUT building anything:
    pick n_shards so this stays within the card's memory before paying the
    route build (the reference keeps it at or under 2^28)."""
    v = ec.vertices_count
    shard_id = ec.dst_ids % n_shards
    worst = 0
    for s in range(n_shards):
        m = shard_id == s
        for deg in (np.bincount(ec.src_ids[m], minlength=v),
                    np.bincount(ec.dst_ids[m], minlength=v)):
            lay = layout_of(deg, cfg)
            slots = (lay.huge_chunks_pad * lay.huge_chunk_w
                     + sum(w * rp for w, rp in lay.buckets))
            worst = max(worst, _next_pow2(max(slots, 256)))
    return worst


def shard_edge_values(coo_values: np.ndarray, sg: ShardedTileGraph,
                      ec: EdgesContainer, hosts: List[Tuple],
                      pad_value=0) -> List[EdgeArray]:
    """Per-shard EdgeArrays for COO-ordered edge values, in each shard's
    CSR slot order (graph/edges.EdgeArray.flat), laid out from the host
    CSRs import_sharded(_host_out=hosts) gave."""
    return [edge_values_of_shard(coo_values, ec, sg.n_shards, s,
                                 sg.shard(s), hosts[s], pad_value)
            for s in range(sg.n_shards)]


def edge_values_of_shard(coo_values: np.ndarray, ec: EdgesContainer,
                         n_shards: int, s: int, graph: VGLGraph, hosts,
                         pad_value=0) -> EdgeArray:
    """Shard s's EdgeArray (one rank's part of shard_edge_values); hosts:
    the shard's (h_out, h_in)."""
    m = ec.dst_ids % n_shards == s
    return build_edge_array_from_host(np.asarray(coo_values)[m], graph,
                                      hosts[0], hosts[1], pad_value=pad_value)
