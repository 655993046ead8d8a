"""Graph import on the target device: COO → degree-sorted CSR → tiles, with
torch tensor operations where graph/build.py runs numpy on the host.

`build_directed_csr_torch` gives, bit for bit, what graph/build.py's
`build_directed_csr` (no imposed layout) gives and graph/device.py uploads:
the same renumbering, CSR, sentinels, padding, buckets and huge chunks, as a
`DeviceDirectedGraph` already on the device. One permutation comes out of
both, because both sort stably:

  - the vertices by descending degree: numpy's stable argsort of -degree is
    torch.sort(-degree, stable=True);
  - the edges by their renumbered source: a stable sort of int32 keys, whose
    indices are the CSR's edge_perm.

The tile layout needs a few host scalars (the degree classes' boundaries and
the huge class's chunk count). They come from the sorted degrees in one small
copy to the host; each bucket and the huge tile are then dense gathers of the
CSR's columns. No per-slot edge index (graph/build.py's eidx) is built: the
card never holds one. `host_csr` makes the host CSR, eidx included, from the
device result where a caller needs it (the advance route's builder).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import VGLConfig, DEFAULT_CONFIG
from .build import (HostBucket, HostDirectedCSR, _build_huge, _next_pow2,
                    _round_up, _slice_rows_to_tile)
from .device import DeviceDirectedGraph, HugeTile, TileBucket

_INT32_LIMIT = 2**31
# degree classes: widths 2^0 .. 2^31 bound any degree of an int32 CSR
_WIDTH_BITS = 32


@dataclasses.dataclass(frozen=True)
class DeviceDirectedCSR:
    """One direction built on the device: the direction as the graph holds
    it, and each CSR slot's COO edge id (edge_perm), which lays out edge
    values (graph/edges.build_edge_array_from_host) and stays on the
    device. The attributes that graph/edges.py and graph/device.py read of
    a host CSR (graph/build.py HostDirectedCSR) read the same here."""

    graph: DeviceDirectedGraph
    edge_perm: torch.Tensor         # int64 [e_pad], pad e_pad

    @property
    def edges_count(self) -> int:
        return self.graph.e

    @property
    def edges_pad(self) -> int:
        return self.graph.e_pad

    @property
    def sorted_to_orig(self) -> torch.Tensor:
        return self.graph.sorted_to_orig

    @property
    def orig_to_sorted(self) -> torch.Tensor:
        return self.graph.orig_to_sorted


def check_extent(edges_count: int, vertices_pad: int) -> None:
    """Raise ValueError for a graph the device CSR cannot hold: its row
    offsets, columns and renumber maps are int32, so it takes fewer than
    2^31 arcs and 2^31 padded vertices."""
    if int(edges_count) >= _INT32_LIMIT:
        raise ValueError(
            f"a graph of {int(edges_count):,} arcs: the device CSR keeps row "
            f"offsets as int32 and takes fewer than 2^31 arcs")
    if int(vertices_pad) >= _INT32_LIMIT:
        raise ValueError(
            f"{int(vertices_pad):,} padded vertices: the device CSR keeps "
            f"vertex ids as int32 and takes fewer than 2^31")


def _ragged_tile(col_idx: torch.Tensor, starts: torch.Tensor,
                 lens: torch.Tensor, width: int, rows_pad: int,
                 fill: int) -> torch.Tensor:
    """int32 [rows_pad, width]: row i holds col_idx[starts[i]:starts[i] +
    min(lens[i], width)] and then `fill`; the rows past len(starts) are all
    `fill`."""
    k = torch.arange(width, dtype=torch.int64, device=col_idx.device)
    pos = (starts[:, None] + k).clamp_(max=col_idx.numel() - 1)
    got = torch.index_select(col_idx, 0, pos.view(-1)).view(pos.shape)
    tile = torch.full((rows_pad, width), fill, dtype=torch.int32,
                      device=col_idx.device)
    tile[:starts.numel()] = torch.where(k < lens[:, None], got, fill)
    return tile


def build_directed_csr_torch(src, dst, vertices_count: int,
                             cfg: VGLConfig = DEFAULT_CONFIG,
                             device=None) -> DeviceDirectedCSR:
    """The degree-sorted CSR and tiles of edges (src -> dst) on `device`
    (default: src's), equal to graph/build.build_directed_csr(src, dst,
    vertices_count, cfg) uploaded by graph/device.py. src, dst: int ids as
    tensors or numpy arrays, moved to `device` once. Raises ValueError past
    the int32 extents (check_extent)."""
    src = torch.as_tensor(src, device=device)
    dst = torch.as_tensor(dst, device=device)
    dev = src.device
    v = int(vertices_count)
    e = src.numel()
    v_pad = max(_next_pow2(v), 1024)
    check_extent(e, v_pad)
    e_pad = max(_round_up(e, 8), 8)

    # stable sort by descending degree → renumber maps (sorted id = rank)
    neg_deg, order = torch.sort(-torch.bincount(src, minlength=v),
                                stable=True)
    o2s = torch.empty(v, dtype=torch.int32, device=dev)
    o2s[order] = torch.arange(v, dtype=torch.int32, device=dev)

    # CSR in sorted order: a stable sort of the renumbered sources; its
    # indices are each CSR slot's COO edge id
    _, csr_order = torch.sort(torch.index_select(o2s, 0, src), stable=True)
    col_idx = torch.full((e_pad,), v_pad, dtype=torch.int32, device=dev)
    col_idx[:e] = torch.index_select(torch.index_select(o2s, 0, dst), 0,
                                     csr_order)
    edge_perm = torch.full((e_pad,), e_pad, dtype=torch.int64, device=dev)
    edge_perm[:e] = csr_order
    del csr_order
    degrees = torch.zeros(v_pad, dtype=torch.int64, device=dev)
    degrees[:v] = -neg_deg
    row_ptr = torch.zeros(v_pad + 1, dtype=torch.int64, device=dev)
    torch.cumsum(degrees, 0, out=row_ptr[1:])
    s2o = torch.full((v_pad,), v, dtype=torch.int32, device=dev)
    s2o[:v] = order
    o2s_pad = torch.full((v_pad,), v, dtype=torch.int32, device=dev)
    o2s_pad[:v] = o2s

    # the host scalars of the layout, in one copy: rows of degree above
    # the huge threshold, above 0 and above each 2^k (the rows are sorted
    # by descending degree, so each count is a row boundary), and the
    # huge rows' chunks
    thr, cw = cfg.huge_degree_threshold, cfg.huge_row_chunk
    bounds = torch.tensor([thr, 0] + [1 << k for k in range(_WIDTH_BITS)],
                          dtype=torch.int64, device=dev)
    deg = degrees[:v]
    n_chunks = torch.where(deg > thr, (deg + cw - 1) // cw, 0).sum()
    scalars = torch.cat([torch.searchsorted(neg_deg, -bounds),
                         n_chunks.view(1)]).tolist()
    n_huge, nonzero = scalars[0], scalars[1]
    above = scalars[2:2 + _WIDTH_BITS]      # above[k]: rows of degree > 2^k
    n_chunks = scalars[-1]

    huge = None
    if n_huge > 0:
        # rows [0, n_huge) cut into chunks of cw slots
        n_chunks_pad = _round_up(max(n_chunks, 8), 8)
        per_row = (degrees[:n_huge] + cw - 1) // cw
        seg = torch.full((n_chunks_pad,), n_huge, dtype=torch.int32,
                         device=dev)
        # chunk c belongs to the row whose chunks end first past c
        ends = torch.cumsum(per_row, 0)
        chunk = torch.arange(n_chunks, dtype=torch.int64, device=dev)
        rows = torch.searchsorted(ends, chunk, right=True)
        seg[:n_chunks] = rows
        starts = row_ptr[rows] + (chunk - (ends - per_row)[rows]) * cw
        # a chunk takes the row's slots left from its start, cw at most
        huge = HugeTile(
            adj=_ragged_tile(col_idx, starts, row_ptr[rows + 1] - starts, cw,
                             n_chunks_pad, v_pad),
            seg_ids=seg,
            seg_lengths=torch.bincount(seg.long(), minlength=n_huge + 1),
            chunk_w=cw, n_rows=n_huge, n_chunks=n_chunks,
            n_chunks_pad=n_chunks_pad)

    # power-of-two ELL buckets over the rows of degree in [1, threshold],
    # widest first: width 2^k holds the degrees in (2^(k-1), 2^k]
    buckets = []
    for k in range(_WIDTH_BITS - 1, -1, -1):
        width = 1 << k
        start = max(above[k], n_huge)
        end = min(above[k - 1] if k else nonzero, nonzero)
        if end <= start:
            continue
        rows = end - start
        rows_pad = _round_up(rows, max(128 // width, 8))
        buckets.append(TileBucket(
            adj=_ragged_tile(col_idx, row_ptr[start:end],
                             degrees[start:end], width, rows_pad, v_pad),
            width=width, row_start=start, rows=rows, rows_pad=rows_pad))

    graph = DeviceDirectedGraph(
        row_ptr=row_ptr.to(torch.int32), col_idx=col_idx,
        degrees=degrees.to(torch.int32), sorted_to_orig=s2o,
        orig_to_sorted=o2s_pad, buckets=tuple(buckets), huge=huge, v=v,
        v_pad=v_pad, e=e, e_pad=e_pad)
    return DeviceDirectedCSR(graph=graph, edge_perm=edge_perm)


def host_csr(d: DeviceDirectedCSR) -> HostDirectedCSR:
    """The host CSR (graph/build.py) of a direction built on the device,
    equal to build_directed_csr's, the tiles' per-slot edge indices (eidx)
    included: what graph/route_build.py's advance route reads."""
    g = d.graph

    def host(t, dtype):
        return t.cpu().numpy().astype(dtype, copy=False)
    h = HostDirectedCSR(
        vertices_count=g.v, vertices_pad=g.v_pad, edges_count=g.e,
        edges_pad=g.e_pad, row_ptr=host(g.row_ptr, np.int64),
        col_idx=host(g.col_idx, np.int32), degrees=host(g.degrees, np.int32),
        edge_perm=host(d.edge_perm, np.int64),
        sorted_to_orig=host(g.sorted_to_orig, np.int32),
        orig_to_sorted=host(g.orig_to_sorted, np.int32), huge=None)
    if g.huge is not None:
        h.huge = _build_huge(h, g.huge.n_rows, g.huge.chunk_w, g.huge.n_rows,
                             g.huge.n_chunks_pad)
    h.buckets = [HostBucket(b.width, b.row_start, b.rows, b.rows_pad,
                            *_slice_rows_to_tile(h, b.row_start, b.rows,
                                                 b.rows_pad, b.width))
                 for b in g.buckets]
    return h
