"""generate_new_frontier: filter vertices by a condition into a new Frontier
(port of vectorgraphlibrary_tpu/ops/frontier_ops.py).

Reference: `vgl_compute_api/common/generate_new_frontier.hpp:3-43` and the NEC
worker that flags, counts per part, and switches representation by density
thresholds (`nec/generate_new_frontier.hpp:209-325`). One pass makes the
dense mask and the active and neighbour counts on the device; the host reads
the count only with classify_on_host.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..config import Sparsity, TraversalDirection, VGLConfig, DEFAULT_CONFIG
from ..graph.device import VGLGraph
from ..graph.frontier import Frontier, classify_sparsity

# cond(ids, degrees, arrays) -> bool [v_pad]


def generate_new_frontier(graph: VGLGraph,
                          cond: Callable,
                          arrays,
                          direction: TraversalDirection = TraversalDirection.SCATTER,
                          cfg: VGLConfig = DEFAULT_CONFIG,
                          classify_on_host: bool = False) -> Frontier:
    dg = graph.direction(direction)
    ids = torch.arange(graph.v_pad, dtype=torch.int32, device=graph.device)
    mask = cond(ids, dg.degrees, arrays) & (ids < graph.v)
    size = torch.sum(mask, dtype=torch.int32)
    nbr = torch.sum(torch.where(mask, dg.degrees, 0), dtype=torch.int32)
    sparsity = Sparsity.DENSE
    if classify_on_host:
        ratio = int(size) / max(graph.v, 1)
        sparsity = classify_sparsity(ratio, cfg.dense_frontier_threshold)
    return Frontier(mask=mask, size=size, neighbours_count=nbr,
                    direction=direction, sparsity=sparsity)
