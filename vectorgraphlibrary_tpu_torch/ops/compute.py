"""Compute: per-vertex map (port of vectorgraphlibrary_tpu/ops/compute.py;
reference common_compute, `vgl_compute_api/common/compute.hpp:61-84`). A masked
elementwise map over the padded vertex space; this port has no frontiers yet,
so every real vertex is active."""
from __future__ import annotations

from typing import Callable, Dict

import torch

from ..config import TraversalDirection
from ..graph.device import VGLGraph

# compute_op(vertex_ids, degrees, arrays: Dict[str, Tensor]) -> Dict[str, Tensor]
# returns updates for a subset of keys; padding vertices keep old values.


def compute(graph: VGLGraph,
            arrays: Dict[str, torch.Tensor],
            compute_op: Callable,
            direction: TraversalDirection = TraversalDirection.SCATTER,
            ) -> Dict[str, torch.Tensor]:
    dg = graph.direction(direction)
    ids = torch.arange(graph.v_pad, dtype=torch.int32, device=graph.device)
    updates = compute_op(ids, dg.degrees, arrays)
    real = ids < graph.v
    out = dict(arrays)
    for k, new in updates.items():
        m = real[:, None] if new.dim() > 1 else real
        out[k] = torch.where(m, new, arrays[k])
    return out
