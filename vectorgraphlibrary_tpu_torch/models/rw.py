"""Random walks (port of vectorgraphlibrary_tpu/models/rw.py).

Capability match for the reference RW (`algorithms/rw/random_walk.hpp:5-118`):
walkers start on given vertices; every step each walker moves to a uniformly
random out-neighbour, for a fixed number of steps; a walker on a vertex with
no out-edges stays there. Walker-parallel over the outgoing CSR: per step one
gather of degree and row start, one uniform draw per walker, one gather of
the chosen column. The reference's `lax.scan` is a host loop of
`walk_length` steps.

Random numbers come from a torch.Generator on the graph's device seeded
from `seed`: the same seed gives the same walks on one device, but not the
JAX package's walks (its counter-based stream cannot be reproduced), so a
walk is held to the reference's properties: every step follows an edge or
stays on a vertex without out-edges, and every final vertex lies in
seq_random_walk_reachable.
"""
from __future__ import annotations

import numpy as np
import torch

from ..graph.device import VGLGraph


def _rw_run(graph: VGLGraph, start_sorted: torch.Tensor,
            gen: torch.Generator, walk_length: int):
    """(final positions, [walk_length, walkers] visited positions), in the
    outgoing container's sorted ids."""
    dg = graph.outgoing
    last = dg.col_idx.shape[0] - 1
    pos = start_sorted
    path = []
    for _ in range(walk_length):
        deg = dg.degrees[pos]
        start = dg.row_ptr[pos]
        r = torch.rand(pos.shape, generator=gen, device=pos.device)
        off = torch.minimum((r * deg).to(torch.int32),
                            torch.clamp(deg - 1, min=0))
        nxt = dg.col_idx[(start + off).clamp(max=last).long()]
        pos = torch.where(deg > 0, nxt, pos)
        path.append(pos)
    return pos, path


def vgl_random_walk(graph: VGLGraph, start_vertices_original,
                    walk_length: int = 10, seed: int = 0,
                    store_walk_paths: bool = False):
    """The final vertex (ORIGINAL id) of each walker as a numpy array; with
    store_walk_paths also the [walkers, walk_length + 1] paths, start
    included."""
    dg = graph.outgoing
    starts_o = torch.as_tensor(np.asarray(start_vertices_original),
                               dtype=torch.int64).to(graph.device)
    starts = dg.orig_to_sorted[starts_o]
    gen = torch.Generator(device=graph.device).manual_seed(seed)
    pos, path = _rw_run(graph, starts, gen, walk_length)
    s2o = dg.sorted_to_orig
    final = s2o[pos.long()].cpu().numpy()
    if not store_walk_paths:
        return final
    full = torch.stack([starts_o.to(torch.int32)]
                       + [s2o[p.long()] for p in path], dim=1)
    return final, full.cpu().numpy()


def seq_random_walk_reachable(ec, start: int, walk_length: int) -> np.ndarray:
    """Oracle support: bool [v], the vertices within walk_length hops of
    start (a random walk's end must lie in this set)."""
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csg
    v = ec.vertices_count
    # f32 ones: int8 ones, as in the reference, wrap negative where more
    # than 127 parallel edges sum (scipy then warns of negative weights)
    a = sp.csr_matrix((np.ones(ec.edges_count, np.float32),
                       (ec.src_ids, ec.dst_ids)), shape=(v, v))
    hops = csg.shortest_path(a, method="D", unweighted=True, directed=True,
                             indices=start)
    return hops <= walk_length
