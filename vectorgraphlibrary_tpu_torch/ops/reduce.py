"""Reduce: sum/max/min over vertex values (port of
vectorgraphlibrary_tpu/ops/reduce.py; reference common_reduce,
`vgl_compute_api/common/reduce.hpp:3-66`). One masked reduction over the real
vertices, or over the frontier's. The result stays on the device as a 0-d
tensor."""
from __future__ import annotations

from typing import Optional

import torch

from ..config import TraversalDirection
from ..graph.device import VGLGraph
from ..graph.frontier import Frontier
from . import monoid as M


def reduce(graph: VGLGraph,
           values: torch.Tensor,
           op,
           frontier: Optional[Frontier] = None,
           direction: TraversalDirection = TraversalDirection.SCATTER,
           ) -> torch.Tensor:
    """values in the frontier's ordering when one is given (its mask selects
    the vertices); `direction` is the reference's and selects nothing."""
    mon = M.get(op)
    real = torch.arange(values.shape[0], device=values.device) < graph.v
    mask = real if frontier is None else (frontier.mask & real)
    ident = mon.identity(values.dtype).to(values.device)
    masked = torch.where(mask if values.dim() == 1 else mask[:, None],
                         values, ident)
    return mon.reduce_axis(masked, 0)
