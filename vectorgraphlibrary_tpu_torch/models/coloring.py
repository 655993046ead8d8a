"""Greedy graph coloring: Jones-Plassmann with speculative assignment in a
sliding window of 32·words colors (port of
vectorgraphlibrary_tpu/models/coloring.py).

Capability match for the reference coloring
(`algorithms/coloring/coloring.hpp:66-158`), validated by the same property
check (`verify_colors`). Every per-edge message is a function of the source
alone, so each neighbourhood query is a pre-masked value pull over the
undirected graph (`common.undirected_value_pull`: two CSR pull kernel
launches and four vertex routes on the card). A round with words = 2 runs
five of them: the int32 min of the uncolored neighbours' priorities, and per
word the int32 or of the banned colors and of the tentative colors.

The reference's uint32 arithmetic (the lowbias32 hash, the rotate, `clz`)
runs here on int64 with `& 0xFFFFFFFF`, since torch has no uint32
arithmetic to rely on on the card: each multiply is split in two 16-bit
halves of the constant so that no int64 product overflows. The lowest set
bit's position is read without `clz`: the isolated bit x & -x is a power of
two, and its position is the sum of the masks it hits (16 if it lies in
0xFFFF0000, 8 in 0xFF00FF00, 4 in 0xF0F0F0F0, 2 in 0xCCCCCCCC, 1 in
0xAAAAAAAA); 0 for no bit, as the reference's clipped clz gives.

The reference's `lax.while_loop` over rounds is a host loop with the same
state and condition that reads two scalars per round (the vertices kept and
left), and `prio` comes from the same numpy permutation, so colors and round
counts equal the JAX package's exactly.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import TraversalDirection
from ..graph.device import VGLGraph
from ..graph.vertices import VertexArray
from . import common

O = TraversalDirection.ORIGINAL
UNCOLORED = -1
_U32 = 0xFFFFFFFF
_BIT_MASKS = ((16, 0xFFFF0000), (8, 0xFF00FF00), (4, 0xF0F0F0F0),
              (2, 0xCCCCCCCC), (1, 0xAAAAAAAA))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c modulo 2^32 for int64 x in [0, 2^32): the constant's two 16-bit
    halves keep every product below 2^48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 integer mix on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _bit_position(lsb: torch.Tensor) -> torch.Tensor:
    """Position of the one set bit of each int64 `lsb` (a power of two below
    2^32), 0 where lsb is 0."""
    pos = torch.zeros_like(lsb)
    for weight, mask in _BIT_MASKS:
        pos += ((lsb & mask) != 0).to(lsb.dtype) * weight
    return pos


def _bits_of(cond: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """int32 1 << pos where cond, else 0 (pos in [0, 32); bit 31 is the sign
    bit, as the reference's int32 shift gives)."""
    one = torch.ones_like(pos, dtype=torch.int32)
    return torch.where(cond, torch.bitwise_left_shift(one, pos.to(torch.int32)),
                       0)


def _coloring_run(graph: VGLGraph, prio: torch.Tensor,
                  colors_init: torch.Tensor, words: int, max_rounds: int,
                  trace=None):
    """Rounds until every vertex is colored or max_rounds (reference
    coloring.py:54-160). prio: a random permutation of v_pad (int32);
    colors_init: pre-assigned colors in ORIGINAL space, UNCOLORED where the
    rounds must pick. Returns (colors, rounds, remaining uncolored).
    `trace`, a list, receives (kept, left) per round."""
    v, v_pad = graph.v, graph.v_pad
    dev = graph.device
    ids = torch.arange(v_pad, dtype=torch.int32, device=dev)
    real = ids < v
    colors = torch.where(real, colors_init, 0).to(torch.int32)
    win = words * 32
    prio_u = prio.to(torch.int64)          # a permutation: non-negative

    def banned_word(colors, base, w):
        """OR of (1 << (color - base - 32w)) over undirected neighbours."""
        in_word = (colors >= 0) & (colors // 32 == base // 32 + w)
        return common.undirected_value_pull(
            graph, _bits_of(in_word, colors % 32), "or")

    rnd, base = 0, 0
    left = int(torch.sum(real, dtype=torch.int32))
    while rnd < max_rounds and left > 0:
        uncolored = (colors == UNCOLORED) & real
        # highest uncolored-neighbour priority (min id = highest)
        prio_masked = torch.where(colors == UNCOLORED, prio, 2**31 - 1)
        nb_best = common.undirected_value_pull(graph, prio_masked, "min")
        # <=: a self-loop makes a vertex its own uncolored neighbour
        winner = uncolored & (prio <= nb_best)

        # a random free color of the window: rotate the free mask by a
        # per-(vertex, round) hash, take the lowest free bit, rotate back
        rot = _hash32(prio_u ^ ((0x9E3779B9 * rnd) & _U32)) & 31
        cand = torch.full((v_pad,), win, dtype=torch.int32, device=dev)
        for w in range(words):
            free = torch.bitwise_not(banned_word(colors, base, w))
            has_free = free != 0
            freeu = free.to(torch.int64) & _U32
            rotated = ((freeu >> rot) | (freeu << ((32 - rot) % 32))) & _U32
            rotated = torch.where(rot == 0, freeu, rotated)
            pos = (_bit_position(rotated & -rotated) + rot) % 32
            word_cand = torch.where(has_free, 32 * w + pos, win)
            cand = torch.minimum(cand, word_cand.to(torch.int32))

        # speculative assignment: a tentative color survives unless an
        # undirected neighbour speculates the same one; winners always stick
        tentative = uncolored & (cand < win)
        conflict = torch.zeros(v_pad, dtype=torch.bool, device=dev)
        mine = _bits_of(torch.ones_like(tentative), cand % 32)
        for w in range(words):
            in_w = cand // 32 == w
            nb_tent = common.undirected_value_pull(
                graph, _bits_of(tentative & in_w, cand % 32), "or")
            conflict = conflict | (in_w & ((nb_tent & mine) != 0))
        keep = tentative & (winner | ~conflict)
        colors = torch.where(keep, base + cand, colors)
        kept, n_unc = common.read_scalars(torch.sum(keep, dtype=torch.int32),
                                          torch.sum(uncolored,
                                                    dtype=torch.int32))
        left = n_unc - kept
        if trace is not None:
            trace.append((kept, left))
        # sliding window: no keep while vertices are left means every winner
        # is saturated in this window
        if kept == 0 and left > 0:
            base += win
        rnd += 1
    remaining = int(torch.sum((colors == UNCOLORED) & real, dtype=torch.int32))
    return colors, rnd, remaining


def host_core_colors(ec, threshold: int) -> np.ndarray:
    """First-fit colors for the dense core (undirected degree > threshold) on
    the host, in descending-degree order (a copy of the reference's numpy
    pass). Returns int32 [v] with -1 on non-core vertices."""
    v = ec.vertices_count
    deg = (np.bincount(ec.src_ids, minlength=v)
           + np.bincount(ec.dst_ids, minlength=v))
    core = deg > threshold
    out = np.full(v, -1, np.int32)
    k = int(core.sum())
    if k == 0:
        return out
    core_ids = np.flatnonzero(core)
    remap = np.full(v, -1, np.int64)
    remap[core_ids] = np.arange(k)
    m = core[ec.src_ids] & core[ec.dst_ids]
    s = remap[ec.src_ids[m]]
    d = remap[ec.dst_ids[m]]
    nl = s != d
    key = np.unique(np.concatenate([s[nl] * k + d[nl], d[nl] * k + s[nl]]))
    s2, d2 = key // k, key % k                    # deduped undirected arcs
    order = np.argsort(-deg[core_ids], kind="stable")   # desc degree
    counts = np.bincount(s2, minlength=k)
    indptr = np.concatenate([[0], np.cumsum(counts)])
    colors = np.full(k, -1, np.int64)
    # banned-color bitmask per vertex, 64-bit words grown on demand
    words = 8
    banned = np.zeros((k, words), np.uint64)
    lowbit = np.uint64(1)
    for u in order:
        bu = banned[u]
        c = -1
        for wd in range(words):
            inv = ~bu[wd]
            if inv:
                c = (wd << 6) + int(inv & (~inv + lowbit)).bit_length() - 1
                break
        if c < 0:                       # all words full: grow
            banned = np.concatenate(
                [banned, np.zeros((k, words), np.uint64)], axis=1)
            c = words << 6
            words *= 2
        colors[u] = c
        nbrs = d2[indptr[u]:indptr[u + 1]]
        banned[nbrs, c >> 6] |= np.uint64(1 << (c & 63))
    out[core_ids] = colors
    return out


def vgl_coloring(graph: VGLGraph, max_colors: int = 64,
                 max_rounds: int = 100_000, seed: int = 0,
                 ec=None, core_threshold: int = 256,
                 core_colors: Optional[np.ndarray] = None,
                 trace=None) -> tuple[VertexArray, int]:
    """Colors in ORIGINAL ordering and the count of rounds. ec (optional):
    the host COO container; when given, the dense core (undirected degree >
    core_threshold) is first-fit colored on the host (host_core_colors) and
    the rounds color the rest against it. core_colors: a precomputed
    host_core_colors result, so that repeated calls pay the host pass once.
    Raises RuntimeError if vertices are left uncolored after max_rounds."""
    rng = np.random.default_rng(seed)
    prio = torch.from_numpy(rng.permutation(graph.v_pad).astype(np.int32)) \
        .to(graph.device)
    words = max(1, (max_colors + 31) // 32)
    if core_colors is None and ec is not None:
        core_colors = host_core_colors(ec, core_threshold)
    init = np.full(graph.v_pad, UNCOLORED, np.int32)
    if core_colors is not None:
        init[:graph.v] = core_colors
    colors, rounds, remaining = _coloring_run(
        graph, prio, torch.from_numpy(init).to(graph.device), words,
        max_rounds, trace)
    if remaining:
        raise RuntimeError(f"{remaining} vertices uncolored after {rounds} "
                           f"rounds: raise max_rounds")
    return VertexArray(values=colors, direction=O), rounds


def seq_coloring(ec) -> np.ndarray:
    """Sequential greedy oracle (first-fit in vertex order)."""
    import scipy.sparse as sp
    v = ec.vertices_count
    und = sp.csr_matrix(
        (np.ones(2 * ec.edges_count, np.int8),
         (np.concatenate([ec.src_ids, ec.dst_ids]),
          np.concatenate([ec.dst_ids, ec.src_ids]))), shape=(v, v))
    colors = np.full(v, -1, np.int64)
    indptr, indices = und.indptr, und.indices
    for u in range(v):
        nb = colors[indices[indptr[u]:indptr[u + 1]]]
        nb = set(nb[nb >= 0].tolist())
        c = 0
        while c in nb:
            c += 1
        colors[u] = c
    return colors.astype(np.int32)
