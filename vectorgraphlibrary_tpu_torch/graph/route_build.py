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


def _slot_owners(buckets, huge, n: int, device):
    """int32 [n]: the row that owns each tile slot of a direction, in
    slot_map's flat order (huge chunks in seg_ids order, then the buckets'
    rows, width slots each); 0 past the tiles. A pad chunk or pad row owns
    slots that hold no edge."""
    import torch
    parts = []
    if huge is not None:
        parts.append(huge.seg_ids.to(device=device, dtype=torch.int32)
                     .repeat_interleave(huge.chunk_w))
    for b in buckets:
        parts.append(torch.arange(b.row_start, b.row_start + b.rows_pad,
                                  dtype=torch.int32, device=device)
                     .repeat_interleave(b.width))
    owners = torch.zeros(n, dtype=torch.int32, device=device)
    if parts:
        flat = torch.cat(parts)
        if flat.numel() > n:
            raise ValueError(f"tiles of {flat.numel()} slots for a route of "
                             f"{n}")
        owners[:flat.numel()] = flat
    return owners


def csrs_from_route(route, out_tiles, in_tiles, s_from_g, v_pad: int):
    """Both directions' CSRs of a graph whose file kept the advance route
    and dropped the CSRs (the JAX package's slim shard), on the route's
    device. route: the advance RoutePlan with its finish flags; out_tiles,
    in_tiles: (buckets, huge) of each direction (metadata and huge seg_ids;
    no adjacency needed); s_from_g: the vertex route whose forward index
    maps a scatter-ordered vertex to its gather-ordered id.

    The inverse of build_advance_route and csr_route_slots:
    - a slot's flags bit 0 marks a real edge, and a row's real slots are its
      first degree(row) slots, so counting each direction's real slots by
      owning row gives its degrees, and their prefix sum its row_ptr;
    - the route's forward index sends each incoming slot the outgoing slot
      it came from, whose owner is the edge's source (scatter order); the
      inverse index sends each outgoing slot its incoming slot, whose owner
      is the destination (gather order); s_from_g maps each into the
      direction's own ordering;
    - csr_route_slots(row_ptr, tiles) lists each CSR slot's tile slot, in
      CSR order, so the columns come out in the order the pull reduces.
    Returns ((row_ptr, col_idx, degrees) of the outgoing direction, the
    same of the incoming, in_route_slots): int32 tensors, col_idx of the
    CSR's own edges. Raises ValueError where the flags and the tiles
    disagree."""
    import torch
    if route.flags_fwd is None or route.flags_inv is None:
        raise ValueError("the advance route holds no finish flags, which "
                         "mark its real edge slots")
    dev = route.fwd_idx.device
    n = route.n
    owners = {d: _slot_owners(*tiles, n, dev)
              for d, tiles in (("out", out_tiles), ("in", in_tiles))}
    # the other direction's owner of each slot, and the vertex map from the
    # other direction's ordering into this one's
    other = {"out": (route.inv_idx, owners["in"], s_from_g.inv_idx),
             "in": (route.fwd_idx, owners["out"], s_from_g.fwd_idx)}
    result = {}
    for d, flags, (buckets, huge) in (("out", route.flags_inv, out_tiles),
                                      ("in", route.flags_fwd, in_tiles)):
        real = (flags & 1) != 0
        degrees = torch.bincount(owners[d][real], minlength=v_pad)
        if degrees.numel() > v_pad:
            raise ValueError(f"{d}: an edge slot owned by row "
                             f"{degrees.numel() - 1} of {v_pad}")
        row_ptr = torch.zeros(v_pad + 1, dtype=torch.int64, device=dev)
        torch.cumsum(degrees, 0, out=row_ptr[1:])
        slots = torch.from_numpy(csr_route_slots(
            row_ptr.cpu().numpy(), buckets, huge)).to(dev)
        if not bool(real[slots].all()):
            raise ValueError(f"{d}: a row's edge slots are not its first "
                             "degree slots")
        route_idx, other_owner, vmap = other[d]
        col = torch.index_select(vmap, 0, torch.index_select(
            other_owner, 0, torch.index_select(route_idx, 0, slots)))
        result[d] = (row_ptr.to(torch.int32), col.to(torch.int32),
                     degrees.to(torch.int32))
        if d == "in":
            result["slots"] = slots.to(torch.int32)
    return result["out"], result["in"], result["slots"]
