"""Host-side construction of the advance routing plan (port of
vectorgraphlibrary_tpu/graph/route_build.py).

Builds the static permutation between the outgoing container's tile slots
(source-grouped, where messages are generated by broadcast) and the incoming
container's tile slots (destination-grouped, where messages are reduced). One
plan serves both traversal directions: pull-over-incoming applies it forward,
pull-over-outgoing (the push/undirected case) applies it inverted. The plan
holds the permutation as a gather index per direction (ops/route.py), so no
Beneš router runs here.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def _next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << int(np.ceil(np.log2(x)))


def slot_map(h) -> tuple[np.ndarray, int]:
    """coo edge id -> flat tile slot (huge chunks first, then buckets in order)."""
    e = h.edges_count
    mapping = np.full(e, -1, np.int64)
    offset = 0
    tiles = []
    if h.huge is not None:
        tiles.append(h.huge.eidx)
    tiles.extend(b.eidx for b in h.buckets)
    for eidx in tiles:
        flat = eidx.ravel()
        valid = flat < e                      # sentinel = edges_pad >= e
        csr_slots = flat[valid].astype(np.int64)
        mapping[h.edge_perm[csr_slots]] = offset + np.flatnonzero(valid)
        offset += flat.size
    assert (mapping >= 0).all(), "some edge missing from tiles"
    return mapping, offset


def build_pull_permutation(h_src_side, h_dst_side):
    """perm[dst_slot] = src_slot over the common padded 2^k slot space.
    Returns (perm, src_total, dst_total, m_src, m_dst) where m_src/m_dst map
    COO edge id -> flat slot on the respective side."""
    m_src, src_total = slot_map(h_src_side)
    m_dst, dst_total = slot_map(h_dst_side)
    n = _next_pow2(max(src_total, dst_total, 256))
    perm = np.full(n, -1, np.int64)
    perm[m_dst] = m_src
    used = np.zeros(n, bool)
    used[m_src] = True
    free_src = np.flatnonzero(~used)
    unassigned = np.flatnonzero(perm < 0)
    perm[unassigned] = free_src[:len(unassigned)]
    return perm, src_total, dst_total, m_src, m_dst


def _slot_flags(n: int, m_edges: np.ndarray,
                selfloop: Optional[np.ndarray]) -> np.ndarray:
    """uint8 [n]: bit0 = slot holds a real edge, bit1 = that edge is a
    self-loop — the static metadata the fused finish epilogue masks with."""
    flags = np.zeros(n, np.uint8)
    flags[m_edges] |= 1
    if selfloop is not None:
        flags[m_edges[selfloop]] |= 2
    return flags


def build_advance_route(h_out, h_in, selfloop_edges: Optional[np.ndarray] = None,
                        device="cuda"):
    """RoutePlan moving outgoing-tile slots → incoming-tile slots, with
    per-slot valid/self-loop flags on both output orders (forward output =
    incoming slots, inverse output = outgoing slots) for the fused advance
    finish. selfloop_edges: bool [e] over COO edge ids. h_out/h_in are
    HostDirectedCSR of either package (graph/build.py)."""
    from ..ops.route import make_route_plan
    perm, out_total, in_total, m_src, m_dst = build_pull_permutation(h_out, h_in)
    n = len(perm)
    flags_fwd = _slot_flags(n, m_dst, selfloop_edges)
    flags_inv = _slot_flags(n, m_src, selfloop_edges)
    return (make_route_plan(perm, flags_fwd=flags_fwd, flags_inv=flags_inv,
                            device=device),
            out_total, in_total)


def csr_route_slots(row_ptr: np.ndarray, buckets, huge=None) -> np.ndarray:
    """int64 [e]: the tile slot of each of a direction's e CSR slots, in the
    flat slot space of slot_map (huge chunks first, then the buckets in
    order); for the incoming direction, the advance route's slot. Made from
    the CSR's row_ptr and the tiles' metadata alone, as the tiles are laid
    out (graph/build.py): a bucket's row r takes slots (r - row_start) *
    width + k of the bucket for its k-th CSR slot, k < its degree; a huge
    row's chunks, in seg_ids order, take chunk_w CSR slots each. buckets:
    objects with width, row_start, rows and rows_pad (host or device
    tiles); huge: one with chunk_w, n_rows, n_chunks_pad and seg_ids, or
    None. So it serves a graph whose tiles are gone (a slim shard) or were
    never read (a loaded file): slot_map(h)[h.edge_perm[j]] for CSR slot j
    of the host CSR h it was built from."""
    rp = np.asarray(row_ptr, np.int64)
    e = int(rp[-1])
    starts, lens, firsts = [], [], []
    offset = 0
    if huge is not None:
        seg = huge.seg_ids
        seg = (seg.cpu().numpy() if hasattr(seg, "cpu") else seg).astype(
            np.int64)
        cw = huge.chunk_w
        chunks = np.flatnonzero(seg < huge.n_rows)     # the rest pad
        rows = seg[chunks]
        first = np.searchsorted(seg[chunks], rows, side="left")
        s = rp[rows] + (np.arange(len(chunks)) - first) * cw
        starts.append(s)
        lens.append(np.minimum(cw, rp[rows + 1] - s))
        firsts.append(offset + chunks * cw)
        offset += huge.n_chunks_pad * cw
    for b in buckets:
        rows = np.arange(b.row_start, min(b.row_start + b.rows, len(rp) - 1))
        deg = rp[rows + 1] - rp[rows]
        if (deg > b.width).any():
            raise ValueError(f"a row of degree {int(deg.max())} in a bucket "
                             f"of width {b.width}")
        starts.append(rp[rows])
        lens.append(deg)
        firsts.append(offset + (rows - b.row_start) * b.width)
        offset += b.rows_pad * b.width
    starts, lens, firsts = (np.concatenate(a) if a else np.zeros(0, np.int64)
                            for a in (starts, lens, firsts))
    run = np.repeat(np.arange(len(lens)), lens)
    k = np.arange(len(run)) - np.repeat(np.cumsum(lens) - lens, lens)
    out = np.full(e, -1, np.int64)
    out[starts[run] + k] = firsts[run] + k
    if (out < 0).any():
        raise ValueError("some CSR slot lies in no tile")
    return out


def in_route_slots(row_ptr: np.ndarray, buckets, huge, device):
    """VGLGraph.in_route_slots of a shard, from its incoming CSR's row_ptr
    and tiles' metadata (csr_route_slots): int32 [e] on `device`."""
    import torch
    return torch.from_numpy(csr_route_slots(row_ptr, buckets, huge).astype(
        np.int32)).to(device)
