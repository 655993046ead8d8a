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
