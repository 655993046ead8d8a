"""Shared algorithm helpers (port of vectorgraphlibrary_tpu/models/common.py)."""
from __future__ import annotations

import numpy as np
import torch

from typing import Callable

from ..config import TraversalDirection
from ..graph.device import VGLGraph
from ..graph.vertices import VertexArray, reorder
from ..ops import monoid as M
from ..ops.advance import advance_pull_value


def select_random_source(ec_or_degrees, seed: int = 0) -> int:
    """Random non-zero-outdegree source vertex (reference apps/bfs/bfs.cpp:36-38
    picks `select_non_zero_degree_vertex`)."""
    degs = ec_or_degrees
    if hasattr(degs, "src_ids"):
        degs = np.bincount(degs.src_ids, minlength=degs.vertices_count)
    rng = np.random.default_rng(seed)
    nz = np.flatnonzero(degs)
    if len(nz) == 0:
        return 0
    return int(nz[rng.integers(0, len(nz))])


def to_direction(graph: VGLGraph, values: torch.Tensor,
                 src_dir: TraversalDirection,
                 dst_dir: TraversalDirection) -> torch.Tensor:
    """Reorder a raw [v_pad] array between orderings."""
    return reorder(VertexArray(values=values, direction=src_dir),
                   graph, dst_dir).values


def outdegrees_in(graph: VGLGraph, direction: TraversalDirection) -> torch.Tensor:
    """Out-degrees expressed in `direction`'s ordering."""
    return to_direction(graph, graph.outgoing.degrees,
                        TraversalDirection.SCATTER, direction)


def indegrees_in(graph: VGLGraph, direction: TraversalDirection) -> torch.Tensor:
    return to_direction(graph, graph.incoming.degrees,
                        TraversalDirection.GATHER, direction)


def next_pow2(x: int) -> int:
    """Smallest power of two >= x (1 for x <= 1)."""
    return 1 if x <= 1 else 1 << (int(x) - 1).bit_length()


def undirected_value_pull(graph: VGLGraph, vec_orig: torch.Tensor,
                          combine) -> torch.Tensor:
    """Aggregate a per-source value over the UNDIRECTED neighbourhood, in
    ORIGINAL ordering (reference common.py:47-73): the value pulled over
    incoming and over outgoing edges, each brought back to ORIGINAL and
    joined by the monoid's combine. Two CSR pull kernel launches and four
    vertex routes on the card. The message is the source's value alone, so
    a caller masks or shifts it elementwise first (coloring's banned-color
    words and priority tests)."""
    O, S, G = (TraversalDirection.ORIGINAL, TraversalDirection.SCATTER,
               TraversalDirection.GATHER)
    v_g = to_direction(graph, vec_orig, O, G)
    via_in = to_direction(graph, advance_pull_value(graph, v_g, combine,
                                                    direction=G), G, O)
    v_s = to_direction(graph, vec_orig, O, S)
    via_out = to_direction(graph, advance_pull_value(graph, v_s, combine,
                                                     direction=S), S, O)
    return M.get(combine).combine(via_in, via_out)


def capacity_tiers(id_cap: int, edge_cap: int) -> list:
    """The three (id_cap, edge_cap) capacities of a sparse push branch,
    ascending, each 1/8 of the next (reference bfs.py:174-180,
    sssp.py:166-172)."""
    tiers = []
    ic, ec_ = id_cap, edge_cap
    while len(tiers) < 3:
        tiers.append((max(ic, 8), max(ec_, 64)))
        ic //= 8
        ec_ //= 8
    return tiers[::-1]


def read_scalars(*scalars) -> list:
    """The host's one read of a level's or sweep's device scalars."""
    return torch.stack(scalars).tolist()


def fixpoint(step: Callable, x0: torch.Tensor,
             max_iterations: int) -> tuple[torch.Tensor, int]:
    """x after applying `step` until it changes nothing, and the count of
    applications: the reference's `lax.while_loop` over the state
    (step(x0), x0, 1) with the condition `it < max_iterations and any(x !=
    prev)`, as a host loop that reads one flag per application."""
    x, prev, it = step(x0), x0, 1
    while it < max_iterations and bool(torch.any(x != prev)):
        x, prev, it = step(x), x, it + 1
    return x, it
