"""Host-side graph import/preprocessing: COO → degree-sorted CSR → padded tile layout.

This is the TPU-native re-design of the reference's VectorCSR import pipeline
(`vgl_datastructures/graphs/undirected_containers/vect_csr/import.hpp:257-337`):

  1. count degrees, sort vertices by descending degree, renumber
     (reference import.hpp:61-99) — unchanged in spirit;
  2. rebuild CSR in sorted order (import.hpp:103-153);
  3. split the vertex space into degree classes. The reference makes a 3-way
     ve/vc/collective split driven by SX-Aurora vector length (`nec_api.hpp:5-43`);
     on TPU we instead build:
       - a "huge" class (deg > cfg.huge_degree_threshold): rows split into
         fixed-width chunks forming a rectangular (n_chunks, chunk_w) matrix — the
         analog of the reference's vector_engine class where all threads cooperate
         on one vertex (`advance_all_active.hpp:40-87`);
       - power-of-two-width ELL buckets for everything else — the analog of the
         VectorExtension's padded column-major VL segments
         (`vector_extension/vector_extension.h:5-59`), except row-major (TPU gathers
         feed lanes from contiguous rows) and width-bucketed so every bucket is a
         dense rectangle with ≤2x padding.

Everything here is NumPy on host, copied from vectorgraphlibrary_tpu/graph/build.py so
both packages lay out the same graph identically; `device.py` ships the result to the
device as dataclasses of torch tensors.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..config import VGLConfig, DEFAULT_CONFIG


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << int(np.ceil(np.log2(x)))


@dataclass(frozen=True)
class TileLayout:
    """A STATIC tile shape plan, decoupled from any one graph's degrees.

    Purpose: shards of a ShardedTileGraph must stack into one pytree (leaves
    [S, ...]) for shard_map / lax.scan, which requires every shard's tiles —
    widths, padded row counts, chunk counts — to be IDENTICAL. A TileLayout is
    computed per shard (`layout_of`), unified by elementwise max (`unify`),
    and then imposed on every shard's build: vertices keep their degree class
    but sorted ids become *tile row positions with gaps* — unused positions
    read as degree-0 rows and mask out of every kernel."""

    huge_chunk_w: int                      # 0 = no huge tile
    huge_rows_pad: int                     # reserved positions for huge rows
    huge_chunks_pad: int
    buckets: tuple                         # ((width, rows_pad), ...) desc width

    @property
    def total_rows(self) -> int:
        return self.huge_rows_pad + sum(rp for _, rp in self.buckets)

    @property
    def bucket_starts(self) -> tuple:
        starts, pos = [], self.huge_rows_pad
        for _, rp in self.buckets:
            starts.append(pos)
            pos += rp
        return tuple(starts)


def layout_of(degrees: np.ndarray, cfg: VGLConfig = DEFAULT_CONFIG) -> TileLayout:
    """Natural layout for a degree multiset (degrees of REAL vertices)."""
    degs = -np.sort(-degrees.astype(np.int64))
    nonzero = int(np.count_nonzero(degs))
    n_huge = int(np.searchsorted(-degs, -cfg.huge_degree_threshold, side="left"))
    cw = cfg.huge_row_chunk
    n_chunks = int(((degs[:n_huge] + cw - 1) // cw).sum()) if n_huge else 0
    buckets = []
    row = n_huge
    width = _next_pow2(int(degs[row])) if row < nonzero else 0
    while row < nonzero:
        lo = max(width // 2 + 1, 1) if width > 1 else 1
        end = int(np.searchsorted(-degs, -(lo - 1), side="left")) if lo > 1 else nonzero
        end = min(max(end, row), nonzero)
        rows = end - row
        if rows > 0:
            rows_pad = _round_up(rows, max(128 // width, 8))
            buckets.append((width, rows_pad))
        row = end
        width = width // 2
        if width == 0 and row < nonzero:
            width = 1
    return TileLayout(
        huge_chunk_w=cw if n_huge else 0,
        huge_rows_pad=_round_up(n_huge, 8) if n_huge else 0,
        huge_chunks_pad=_round_up(max(n_chunks, 8), 8) if n_huge else 0,
        buckets=tuple(buckets))


def unify_layouts(layouts) -> TileLayout:
    """Elementwise max over shard layouts → one stackable static shape."""
    cw = max(l.huge_chunk_w for l in layouts)
    widths = sorted({w for l in layouts for w, _ in l.buckets}, reverse=True)
    buckets = tuple(
        (w, max((rp for l in layouts for w2, rp in l.buckets if w2 == w),
                default=0))
        for w in widths)
    return TileLayout(
        huge_chunk_w=cw,
        huge_rows_pad=max(l.huge_rows_pad for l in layouts),
        huge_chunks_pad=max(l.huge_chunks_pad for l in layouts),
        buckets=buckets)


@dataclass
class HostBucket:
    """A contiguous degree-sorted vertex range whose rows are padded to width."""

    width: int
    row_start: int          # first sorted vertex id in this bucket
    rows: int               # actual number of rows
    rows_pad: int           # rows padded (multiple of 8)
    adj: np.ndarray         # int32 [rows_pad, width]; sentinel = vertices_pad
    eidx: np.ndarray        # int32 [rows_pad, width]; CSR edge slot, sentinel = e_pad


@dataclass
class HostHuge:
    """Row-split high-degree class: chunks of fixed width, sorted chunk→row ids."""

    chunk_w: int
    n_rows: int             # number of huge vertices (sorted ids [0, n_rows))
    n_chunks: int
    n_chunks_pad: int
    adj: np.ndarray         # int32 [n_chunks_pad, chunk_w]
    eidx: np.ndarray        # int32 [n_chunks_pad, chunk_w]
    seg_ids: np.ndarray     # int32 [n_chunks_pad]: owning sorted vertex id (sorted asc)


@dataclass
class HostDirectedCSR:
    """One direction (outgoing or incoming) of the graph, degree-sorted."""

    vertices_count: int
    vertices_pad: int
    edges_count: int
    edges_pad: int
    row_ptr: np.ndarray        # int64 [vertices_pad+1]
    col_idx: np.ndarray        # int32 [edges_pad] (sorted-space ids; sentinel pad)
    degrees: np.ndarray        # int32 [vertices_pad]
    edge_perm: np.ndarray      # int64 [edges_pad]: original COO edge id per CSR slot
    sorted_to_orig: np.ndarray  # int32 [vertices_pad]: sorted id -> original id
    orig_to_sorted: np.ndarray  # int32 [vertices_pad]: original id -> sorted id
    huge: Optional[HostHuge]
    buckets: List[HostBucket] = field(default_factory=list)


def build_directed_csr(src: np.ndarray, dst: np.ndarray, vertices_count: int,
                       cfg: VGLConfig = DEFAULT_CONFIG,
                       layout: Optional[TileLayout] = None,
                       v_pad: Optional[int] = None) -> HostDirectedCSR:
    """Build a degree-sorted CSR + tile layout for edges (src -> dst).

    Both endpoints are expressed in the *sorted* id space of this direction, exactly
    as the reference renumbers the whole graph per direction (import.hpp:61-99).

    With `layout` (sharded build): sorted ids become tile ROW POSITIONS under
    the imposed static layout — each vertex keeps its natural degree class, the
    k-th vertex of a class lands at class_start + k, and unused positions are
    gaps that read as degree-0 rows. Zero-degree vertices fill gaps first so
    v_pad stays tight. This is what makes per-shard graphs stack into one
    static-shaped pytree.
    """
    v = vertices_count
    e = int(src.shape[0])

    degrees = np.bincount(src, minlength=v).astype(np.int64)
    # stable sort by descending degree → renumber maps
    order = np.argsort(-degrees, kind="stable")            # dense rank -> orig id
    deg_rank = degrees[order]

    if layout is None:
        # dense renumbering: sorted id = dense rank
        # power-of-two padding: vertex-space permutations (reorders) and slot
        # routes run through Beneš networks, which need 2^k extents
        v_pad = v_pad or max(_next_pow2(v), 1024)
        pos_of_rank = np.arange(v, dtype=np.int64)
    else:
        pos_of_rank = _layout_positions(deg_rank, layout, cfg)
        need = int(pos_of_rank.max()) + 1 if v else 1
        v_pad = v_pad or max(_next_pow2(need), 1024)
        assert need <= v_pad, (need, v_pad)

    orig_to_sorted = np.empty(v, dtype=np.int64)
    orig_to_sorted[order] = pos_of_rank

    s2 = orig_to_sorted[src]
    d2 = orig_to_sorted[dst]

    # CSR in sorted order; edge_perm remembers each CSR slot's original COO index so
    # EdgeArray values can be laid out per direction (reference edges_reorder_indexes,
    # import.hpp:157-165). Positions are monotone in dense rank, so sorting by
    # position == sorting by rank (gap rows carry no edges).
    csr_order = np.argsort(s2, kind="stable")
    s2 = s2[csr_order]
    d2 = d2[csr_order]
    deg_pos = np.zeros(v_pad, dtype=np.int64)
    deg_pos[pos_of_rank] = deg_rank
    row_ptr = np.zeros(v_pad + 1, dtype=np.int64)
    np.cumsum(deg_pos, out=row_ptr[1:])

    e_pad = max(_round_up(e, 8), 8)
    col_idx = np.full(e_pad, v_pad, dtype=np.int32)
    col_idx[:e] = d2
    edge_perm = np.full(e_pad, e_pad, dtype=np.int64)
    edge_perm[:e] = csr_order

    s2o = np.full(v_pad, v, dtype=np.int32)
    s2o[pos_of_rank] = order
    o2s = np.full(v_pad, v, dtype=np.int32)
    o2s[:v] = orig_to_sorted

    out = HostDirectedCSR(
        vertices_count=v, vertices_pad=v_pad, edges_count=e, edges_pad=e_pad,
        row_ptr=row_ptr, col_idx=col_idx, degrees=deg_pos.astype(np.int32),
        edge_perm=edge_perm, sorted_to_orig=s2o, orig_to_sorted=o2s, huge=None,
    )
    _build_tiles(out, cfg, layout)
    return out


def _layout_positions(deg_rank: np.ndarray, layout: TileLayout,
                      cfg: VGLConfig) -> np.ndarray:
    """Tile row position of each dense rank under an imposed layout.

    Ranks are degree-sorted descending; the k-th vertex of each degree class
    goes to class_start + k; zero-degree vertices fill the layout's gap
    positions first, then the tail."""
    v = len(deg_rank)
    pos = np.empty(v, dtype=np.int64)
    starts = dict(zip([w for w, _ in layout.buckets], layout.bucket_starts))
    caps = dict(layout.buckets)
    n_huge = int(np.searchsorted(-deg_rank, -cfg.huge_degree_threshold,
                                 side="left"))
    assert n_huge <= max(layout.huge_rows_pad, 0), \
        f"shard has {n_huge} huge rows > layout {layout.huge_rows_pad}"
    pos[:n_huge] = np.arange(n_huge)
    nonzero = int(np.count_nonzero(deg_rank))
    row = n_huge
    while row < nonzero:
        w = max(int(_next_pow2(int(deg_rank[row]))), 1)
        lo = max(w // 2 + 1, 1) if w > 1 else 1
        end = (int(np.searchsorted(-deg_rank, -(lo - 1), side="left"))
               if lo > 1 else nonzero)
        end = min(max(end, row), nonzero)
        cnt = end - row
        assert w in starts and cnt <= caps[w], \
            f"bucket w={w}: {cnt} rows > layout capacity {caps.get(w)}"
        pos[row:end] = starts[w] + np.arange(cnt)
        row = end
    # zero-degree vertices: fill gaps, then the tail
    n_zero = v - nonzero
    if n_zero > 0:
        used = np.zeros(layout.total_rows, bool)
        used[pos[:nonzero]] = True
        free = np.flatnonzero(~used)
        take = min(len(free), n_zero)
        pos[nonzero:nonzero + take] = free[:take]
        if take < n_zero:
            pos[nonzero + take:] = layout.total_rows + np.arange(n_zero - take)
    return pos


def _slice_rows_to_tile(csr: HostDirectedCSR, row_start: int, rows: int,
                        rows_pad: int, width: int):
    """Extract padded (rows_pad, width) adjacency + edge-slot tiles for a contiguous
    degree-sorted row range whose degrees are all ≤ width."""
    adj = np.full((rows_pad, width), csr.vertices_pad, dtype=np.int32)
    eidx = np.full((rows_pad, width), csr.edges_pad, dtype=np.int64)
    if rows == 0:        # shard has no rows in this (unified-layout) bucket
        return adj, eidx
    rp = csr.row_ptr
    degs = csr.degrees[row_start:row_start + rows].astype(np.int64)
    # vectorized ragged copy: flat positions of all (row, k<deg) slots
    row_local = np.repeat(np.arange(rows, dtype=np.int64), degs)
    k = np.arange(degs.sum(), dtype=np.int64) - np.repeat(
        np.concatenate(([0], np.cumsum(degs)[:-1])), degs)
    src_pos = rp[row_start] + np.arange(degs.sum(), dtype=np.int64)
    adj[row_local, k] = csr.col_idx[src_pos]
    eidx[row_local, k] = src_pos
    return adj, eidx.astype(np.int64)


def _build_huge(csr: HostDirectedCSR, n_huge: int, cw: int, n_rows_static: int,
                n_chunks_pad: int) -> HostHuge:
    """Row-split chunk tile for the first n_huge (degree-sorted) rows."""
    hdeg = csr.degrees[:n_huge].astype(np.int64)
    chunks_per_row = ((hdeg + cw - 1) // cw).astype(np.int64)
    n_chunks = int(chunks_per_row.sum())
    assert n_chunks <= n_chunks_pad, (n_chunks, n_chunks_pad)
    adj = np.full((n_chunks_pad, cw), csr.vertices_pad, dtype=np.int32)
    eidx = np.full((n_chunks_pad, cw), csr.edges_pad, dtype=np.int64)
    # padding chunks map to the one-past-the-end segment (trimmed by reduce)
    seg = np.full(n_chunks_pad, max(n_rows_static, 1), dtype=np.int32)
    if n_huge == 0:      # layout reserves a huge tile this shard doesn't use
        return HostHuge(chunk_w=cw, n_rows=n_rows_static, n_chunks=0,
                        n_chunks_pad=n_chunks_pad, adj=adj, eidx=eidx,
                        seg_ids=seg)
    seg[:n_chunks] = np.repeat(np.arange(n_huge, dtype=np.int32), chunks_per_row)
    # vectorized fill: chunk-local offsets
    chunk_row = seg[:n_chunks].astype(np.int64)
    chunk_first = np.concatenate(([0], np.cumsum(chunks_per_row)[:-1]))
    chunk_in_row = np.arange(n_chunks, dtype=np.int64) - chunk_first[chunk_row]
    starts = csr.row_ptr[chunk_row] + chunk_in_row * cw
    lens = np.minimum(cw, csr.row_ptr[chunk_row + 1] - starts)
    flat_chunk = np.repeat(np.arange(n_chunks, dtype=np.int64), lens)
    flat_k = np.arange(lens.sum(), dtype=np.int64) - np.repeat(
        np.concatenate(([0], np.cumsum(lens)[:-1])), lens)
    flat_pos = np.repeat(starts, lens) + flat_k
    adj[flat_chunk, flat_k] = csr.col_idx[flat_pos]
    eidx[flat_chunk, flat_k] = flat_pos
    return HostHuge(chunk_w=cw, n_rows=n_rows_static, n_chunks=n_chunks,
                    n_chunks_pad=n_chunks_pad, adj=adj, eidx=eidx, seg_ids=seg)


def _build_tiles(csr: HostDirectedCSR, cfg: VGLConfig,
                 layout: Optional[TileLayout] = None) -> None:
    v = csr.vertices_count
    if layout is not None:
        # imposed static layout (sharded build): classes sit at fixed starts,
        # padding/gap rows read as degree 0 and mask out
        degs_pos = csr.degrees.astype(np.int64)
        if layout.huge_chunk_w > 0:
            n_huge = int(np.count_nonzero(
                degs_pos[:layout.huge_rows_pad] > cfg.huge_degree_threshold))
            csr.huge = _build_huge(csr, n_huge, layout.huge_chunk_w,
                                   layout.huge_rows_pad,
                                   layout.huge_chunks_pad)
            # n_chunks is static metadata: unify so shards stack
            csr.huge.n_chunks = layout.huge_chunks_pad
        buckets: List[HostBucket] = []
        for (width, rows_pad), start in zip(layout.buckets,
                                            layout.bucket_starts):
            cnt = int(np.count_nonzero(degs_pos[start:start + rows_pad]))
            adj, eidx = _slice_rows_to_tile(csr, start, cnt, rows_pad, width)
            # rows == rows_pad: uniform static shape; gap rows reduce to the
            # combine identity, which is correct for empty rows
            buckets.append(HostBucket(width=width, row_start=start,
                                      rows=rows_pad, rows_pad=rows_pad,
                                      adj=adj, eidx=eidx))
        csr.buckets = buckets
        return

    degs = csr.degrees[:v].astype(np.int64)
    nonzero = int(np.count_nonzero(degs))          # rows with deg>=1 come first

    # huge class: first n_huge rows with deg > threshold → row-split chunks
    n_huge = int(np.searchsorted(-degs, -cfg.huge_degree_threshold, side="left"))
    if n_huge > 0:
        cw = cfg.huge_row_chunk
        chunks_per_row = ((degs[:n_huge] + cw - 1) // cw).astype(np.int64)
        n_chunks_pad = _round_up(max(int(chunks_per_row.sum()), 8), 8)
        csr.huge = _build_huge(csr, n_huge, cw, n_huge, n_chunks_pad)

    # power-of-two ELL buckets over the remaining rows with deg in [1, threshold]
    buckets = []
    row = n_huge
    width = _next_pow2(int(degs[row])) if row < nonzero else 0
    while row < nonzero:
        lo = max(width // 2 + 1, 1) if width > 1 else 1
        # rows with degree in [lo, width] are contiguous (degree-sorted desc)
        end = int(np.searchsorted(-degs, -(lo - 1), side="left")) if lo > 1 else nonzero
        end = min(max(end, row), nonzero)
        rows = end - row
        if rows > 0:
            # narrow buckets (width < 128) are stored flat lane-major on device:
            # rows_pad must make rows_pad*width a multiple of 128 lanes
            rows_pad = _round_up(rows, max(128 // width, 8))
            adj, eidx = _slice_rows_to_tile(csr, row, rows, rows_pad, width)
            buckets.append(HostBucket(width=width, row_start=row, rows=rows,
                                      rows_pad=rows_pad, adj=adj, eidx=eidx))
        row = end
        width = width // 2
        if width == 0 and row < nonzero:   # safety: should not happen
            width = 1
    csr.buckets = buckets
