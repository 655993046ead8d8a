"""TC: transitive closure (the reference's TC) and triangle counting (port of
vectorgraphlibrary_tpu/models/tc.py).

Transitive closure matches `algorithms/tc/tc.h:15-21`: `vgl_purdoms` (SCC
condensation, cross-component edges deduplicated, reachability on the
condensed DAG; Purdom's method, tc.hpp:5-60) and per-source BFS. The
condensed graph is imported without its advance route (no advance reads
it); its BFS is the top-down push (one expand-and-scatter kernel launch per
level on the card).

Triangle counting (count = trace(A·A·A)/6 of the undirected simple graph):
each degree-oriented edge (u, v) adds |N+(u) ∩ N+(v)|, computed by column
block: per block the out-neighbourhoods become an int32 [v + 1, words]
bitmap, built by one int32 add scatter (one scatter_combine launch on the
card), and the edges whose two rows both touch the block (the presence
filter, torch ops on the same device) are intersected by the AND-popcount
kernel, which returns one int32 sum per chunk of edges. Chunk sums are
added as Python ints, so the total never wraps. The oriented edges go to
the device once, and the filter keeps their order (sorted by u, then v,
which the kernel's runs of equal u rely on for speed).
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..graph.device import VGLGraph, import_graph
from ..graph.vertices import as_original_numpy
from ..io.edges_container import EdgesContainer
from ..ops import monoid as M
from ..ops.cuda.and_popcount import and_popcount
from . import bfs as bfs_mod
from . import scc as scc_mod


# ---------------------------------------------------------------- transitive closure
def vgl_purdoms(ec: EdgesContainer, graph: VGLGraph):
    """Purdom: condense the SCCs and dedupe cross-component edges. Returns
    (dense component id per vertex, condensed EdgesContainer)."""
    labels = scc_mod.vgl_forward_backward(graph)
    lab = labels.values[:graph.v].cpu().numpy()
    uniq, dense = np.unique(lab, return_inverse=True)
    csrc = dense[ec.src_ids]
    cdst = dense[ec.dst_ids]
    keep = csrc != cdst
    key = csrc[keep].astype(np.int64) * len(uniq) + cdst[keep]
    ukey = np.unique(key)
    cec = EdgesContainer((ukey // len(uniq)).astype(np.int32),
                         (ukey % len(uniq)).astype(np.int32), len(uniq))
    return dense.astype(np.int32), cec


def reachability(ec: EdgesContainer, graph: VGLGraph, sources) -> np.ndarray:
    """bool [len(sources), v]: multi-source reachability through the
    vgl_purdoms condensation, one top-down BFS per source on the condensed
    graph (imported on graph's device with build_route=False)."""
    dense, cec = vgl_purdoms(ec, graph)
    out = np.zeros((len(sources), graph.v), bool)
    if cec.edges_count == 0:
        for i, s in enumerate(sources):
            out[i] = dense == dense[s]
        return out
    cg = import_graph(cec, device=graph.device, build_route=False)
    for i, s in enumerate(sources):
        lv = as_original_numpy(bfs_mod.vgl_top_down(cg, int(dense[s])), cg)
        out[i] = lv[dense] != bfs_mod.UNVISITED
    return out


def vgl_bfs_based_reachability(graph: VGLGraph, sources) -> np.ndarray:
    """Per-source BFS reachability (reference tc `vgl_bfs_based`)."""
    rows = []
    for s in sources:
        lv = as_original_numpy(bfs_mod.vgl_top_down(graph, int(s)), graph)
        rows.append(lv != bfs_mod.UNVISITED)
    return np.stack(rows)


def seq_reachability(ec: EdgesContainer, sources) -> np.ndarray:
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csg
    v = ec.vertices_count
    # f32 ones: int8 ones, as in the reference, wrap negative where more
    # than 127 parallel edges sum (scipy then warns of negative weights)
    a = sp.csr_matrix((np.ones(ec.edges_count, np.float32),
                       (ec.src_ids, ec.dst_ids)), shape=(v, v))
    hops = csg.shortest_path(a, method="D", unweighted=True, directed=True,
                             indices=np.asarray(sources))
    return ~np.isinf(hops)


# ---------------------------------------------------------------- triangle counting
def _oriented_simple_edges(ec: EdgesContainer):
    """Degree-oriented deduped edge list of the undirected simple graph:
    (u, v) kept iff (deg, id) of u < (deg, id) of v, so every triangle
    appears exactly once as a directed wedge closure."""
    v = ec.vertices_count
    s = np.concatenate([ec.src_ids, ec.dst_ids]).astype(np.int64)
    d = np.concatenate([ec.dst_ids, ec.src_ids]).astype(np.int64)
    keep = s != d
    s, d = s[keep], d[keep]
    key = np.unique(s * v + d)              # dedupe parallel edges
    s, d = key // v, key % v
    deg = np.bincount(s, minlength=v)       # undirected simple degree
    rank = deg.astype(np.int64) * v + np.arange(v)   # total order (deg, id)
    fwd = rank[s] < rank[d]
    return s[fwd].astype(np.int32), d[fwd].astype(np.int32)


def _tc_build_bits(u_blk: torch.Tensor, v_local: torch.Tensor, v_rows: int,
                   words: int) -> torch.Tensor:
    """One column block's oriented edges as an int32 [v_rows + 1, words]
    bitmap (the last row stays zero): one add of bit v_local & 31 into word
    v_local >> 5 of row u_blk per edge, flattened to index row · words +
    word. The edges are deduplicated, so every (row, word, bit) is added
    once and the add is an or (bit 31 adds -2^31 in int32). The bitmap is
    made here and the add goes into it in place (Monoid.scatter_at_): one
    zero fill and one scatter_combine launch, no copy of the bitmap."""
    n_bits = (v_rows + 1) * words
    if n_bits >= 2**31:
        raise ValueError(f"triangle count: a [{v_rows + 1}, {words}] bitmap "
                         f"exceeds int32 indices; lower block_bits")
    bits = torch.zeros(n_bits, dtype=torch.int32, device=u_blk.device)
    idx = u_blk * words + (v_local >> 5)
    bit = torch.bitwise_left_shift(torch.ones_like(v_local), v_local & 31)
    return M.ADD.scatter_at_(bits, idx, bit).view(v_rows + 1, words)


def _tc_block_count(bits: torch.Tensor, u_e: torch.Tensor, v_e: torch.Tensor,
                    chunk: int) -> torch.Tensor:
    """Per-chunk sums of popcount(bits[u] & bits[v]) over the edges, int32
    [ceil(n / chunk)]: one AND-popcount kernel launch on the card."""
    return and_popcount(bits, u_e, v_e, chunk)


def vgl_triangle_count(ec: EdgesContainer, block_bits: Optional[int] = None,
                       edge_chunk: int = 1 << 15, _oriented=None,
                       device="cuda", trace=None) -> int:
    """Triangle count on `device` by column-blocked bitmaps: per block of
    block_bits columns (default 2^32 / v, clamped to [2^10, 2^20] as in the
    reference, so that the [v, block_bits / 32] int32 bitmap stays near
    0.5 GB), the presence-filtered edges' chunk sums. _oriented: a
    precomputed _oriented_simple_edges(ec), so that a benchmark times the
    host pass apart. `trace`, a list, receives per block (first column,
    edges built, edges counted, filter seconds, count seconds) and None for
    a skipped block: the filter (on `device`, ending in the reads of its
    sizes) and the bitmap build with the AND-popcount (ending in the read of
    its chunk sums), each on the host's clock."""
    v = ec.vertices_count
    u_e, v_e = (_oriented if _oriented is not None
                else _oriented_simple_edges(ec))
    if len(u_e) == 0:
        return 0
    if block_bits is None:
        block_bits = int(min(max(1 << 10, (1 << 32) // max(v, 1)), 1 << 20))
    block_bits = max(32, block_bits)
    words = block_bits // 32
    # an edge adds at most the bits of u's row: keep each chunk's int32 sum
    # exact
    row_max = min(block_bits, int(np.bincount(u_e).max()))
    if edge_chunk * row_max >= 2**31:
        raise ValueError(f"triangle count: chunks of {edge_chunk} edges may "
                         f"sum past int32; lower edge_chunk")
    device = torch.device(device)
    # one upload of the oriented edges; the per-block filter runs on device
    ud, vd = (torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
              for a in (u_e, v_e))
    pres = torch.zeros(v + 1, dtype=torch.bool, device=device)

    total = 0
    for c0 in range(0, v, block_bits):
        t0 = time.perf_counter()
        m = torch.nonzero((vd >= c0) & (vd < c0 + block_bits)).flatten()
        if m.shape[0] == 0:
            if trace is not None:
                trace.append(None)
            continue
        ub, vb = ud[m], vd[m] - c0
        # presence filter: popcount(bits[u] & bits[v]) is 0 unless both rows
        # have a neighbour inside the block
        pres.zero_()
        pres[ub] = True
        em = torch.nonzero(pres[ud] & pres[vd]).flatten()
        if em.shape[0] == 0:
            if trace is not None:
                trace.append(None)
            continue
        uf, vf = ud[em], vd[em]
        t1 = time.perf_counter()
        bits = _tc_build_bits(ub, vb, v, words)
        chunk_sums = _tc_block_count(bits, uf, vf, edge_chunk).tolist()
        total += sum(chunk_sums)            # host ints: no 2^31 wrap
        if trace is not None:
            trace.append((c0, ub.shape[0], uf.shape[0], t1 - t0,
                          time.perf_counter() - t1))
    return total


def seq_triangle_count(ec: EdgesContainer) -> int:
    """Independent oracle: SciPy masked sparse product trace(A·A·A)/6."""
    import scipy.sparse as sp
    v = ec.vertices_count
    s = np.concatenate([ec.src_ids, ec.dst_ids])
    d = np.concatenate([ec.dst_ids, ec.src_ids])
    keep = s != d
    # int64 data: int8 path counts overflow on hub-heavy graphs
    a = sp.csr_matrix((np.ones(keep.sum(), np.int64), (s[keep], d[keep])),
                      shape=(v, v))
    a.data[:] = 1                      # dedupe parallel edges
    a2 = a @ a
    return int((a2.multiply(a)).sum()) // 6


def seq_oriented_triangle_count(u_e: np.ndarray, v_e: np.ndarray,
                                v: int) -> int:
    """Oracle on the oriented edges (_oriented_simple_edges): the sum of
    (A+ · A+) ∘ A+, which forms only the oriented wedges and so stays cheap
    where the hubs' full neighbourhoods make seq_triangle_count's A · A
    large. Summed over 8 row chunks per host core, one thread per core
    (scipy's sparse product releases the GIL)."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    import scipy.sparse as sp
    a = sp.csr_matrix((np.ones(len(u_e), np.int64), (u_e, v_e)), shape=(v, v))
    workers = len(os.sched_getaffinity(0))
    bounds = np.linspace(0, v, 8 * workers + 1).astype(np.int64)

    def rows(r0, r1):
        b = a[r0:r1]
        return int((b @ a).multiply(b).sum())
    with ThreadPoolExecutor(workers) as ex:
        return sum(ex.map(rows, bounds[:-1], bounds[1:]))
