"""VertexArray: |V|-sized device data tagged with a traversal ordering (port of
vectorgraphlibrary_tpu/graph/vertices.py).

Values live in one of three orderings — ORIGINAL, SCATTER
(outgoing-degree-sorted), GATHER (incoming-degree-sorted) — and ``reorder``
permutes between them through the graph's vertex routes (reference
`graphs/vgl_graph/reorder.hpp:3-60`). Padding slots map to themselves; only
the first v slots are contractual.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import TraversalDirection
from ..ops.route import apply_route
from .device import VGLGraph


@dataclasses.dataclass(frozen=True)
class VertexArray:
    values: torch.Tensor     # [v_pad]
    direction: TraversalDirection = TraversalDirection.ORIGINAL


def _route_for(graph: VGLGraph, src: TraversalDirection,
               dst: TraversalDirection):
    """(plan, inverse) executing the src->dst ordering change."""
    O, S, G = (TraversalDirection.ORIGINAL, TraversalDirection.SCATTER,
               TraversalDirection.GATHER)
    table = {
        (G, S): (graph.vertex_route_s_from_g, False),
        (S, G): (graph.vertex_route_s_from_g, True),
        (O, S): (graph.vertex_route_s_from_o, False),
        (S, O): (graph.vertex_route_s_from_o, True),
        (O, G): (graph.vertex_route_g_from_o, False),
        (G, O): (graph.vertex_route_g_from_o, True),
    }
    return table[(src, dst)]


def reorder(arr: VertexArray, graph: VGLGraph,
            direction: TraversalDirection) -> VertexArray:
    if arr.direction == direction:
        return arr
    plan, inverse = _route_for(graph, arr.direction, direction)
    return VertexArray(values=apply_route(plan, arr.values, inverse=inverse),
                       direction=direction)


def as_original_numpy(arr: VertexArray, graph: VGLGraph) -> np.ndarray:
    """Host copy in ORIGINAL ordering, trimmed to the real vertex count — used
    by the verification path (reference verify_results.h:49-51)."""
    out = reorder(arr, graph, TraversalDirection.ORIGINAL)
    return out.values[:graph.v].cpu().numpy()
