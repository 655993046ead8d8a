"""Reduce: sum/max/min over vertex values (port of
vectorgraphlibrary_tpu/ops/reduce.py; reference common_reduce,
`vgl_compute_api/common/reduce.hpp:3-66`). One masked reduction over the real
vertices; this port has no frontiers yet. The result stays on the device as a
0-d tensor."""
from __future__ import annotations

import torch

from ..config import TraversalDirection
from ..graph.device import VGLGraph
from . import monoid as M


def reduce(graph: VGLGraph,
           values: torch.Tensor,
           op,
           direction: TraversalDirection = TraversalDirection.SCATTER,
           ) -> torch.Tensor:
    mon = M.get(op)
    real = torch.arange(values.shape[0], device=values.device) < graph.v
    ident = mon.identity(values.dtype).to(values.device)
    masked = torch.where(real if values.dim() == 1 else real[:, None],
                         values, ident)
    return mon.reduce_axis(masked, 0)
