"""Compute: per-vertex map (port of vectorgraphlibrary_tpu/ops/compute.py;
reference common_compute, `vgl_compute_api/common/compute.hpp:61-84`). A masked
elementwise map over the padded vertex space: every real vertex, or the
frontier's vertices, take the update."""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..config import TraversalDirection
from ..graph.device import VGLGraph
from ..graph.frontier import Frontier

# compute_op(vertex_ids, degrees, arrays: Dict[str, Tensor]) -> Dict[str, Tensor]
# returns updates for a subset of keys; inactive and padding vertices keep
# their old values.


def compute(graph: VGLGraph,
            arrays: Dict[str, torch.Tensor],
            compute_op: Callable,
            frontier: Optional[Frontier] = None,
            direction: TraversalDirection = TraversalDirection.SCATTER,
            ) -> Dict[str, torch.Tensor]:
    """With a frontier, its direction replaces `direction` (the degrees
    compute_op sees and the ordering of the arrays) and only its vertices
    take the update."""
    if frontier is not None:
        direction = frontier.direction
    dg = graph.direction(direction)
    ids = torch.arange(graph.v_pad, dtype=torch.int32, device=graph.device)
    updates = compute_op(ids, dg.degrees, arrays)
    real = ids < graph.v
    mask = real if frontier is None else (frontier.mask & real)
    out = dict(arrays)
    for k, new in updates.items():
        m = mask[:, None] if new.dim() > 1 else mask
        out[k] = torch.where(m, new, arrays[k])
    return out
