"""Shared algorithm helpers (port of vectorgraphlibrary_tpu/models/common.py)."""
from __future__ import annotations

import numpy as np
import torch

from ..config import TraversalDirection
from ..graph.device import VGLGraph
from ..graph.vertices import VertexArray, reorder


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
