"""Frontier: the set of active vertices (port of
vectorgraphlibrary_tpu/graph/frontier.py).

Capability match for the reference ``VGL_Frontier``
(`vgl_datastructures/frontier/frontier.h:13-54`) with sparsity states
ALL_ACTIVE / DENSE / SPARSE (`framework_types.h:156-160`). The canonical form
is a dense bool mask over the padded vertex space in the current traversal
ordering, with its active count and active-neighbour count kept on the device
as 0-d int32 tensors (read on the host only where a heuristic needs them). A
compacted-ids form of static capacity is made on demand for the sparse push.
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import Sparsity, TraversalDirection
from .device import VGLGraph


@dataclasses.dataclass(frozen=True)
class Frontier:
    mask: torch.Tensor              # bool [v_pad], current ordering
    size: torch.Tensor              # int32 0-d: active vertices
    neighbours_count: torch.Tensor  # int32 0-d: sum of degrees of the active
    direction: TraversalDirection = TraversalDirection.SCATTER
    sparsity: Sparsity = Sparsity.ALL_ACTIVE


def _i32(x: int, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.int32, device=device)


def all_active(graph: VGLGraph,
               direction: TraversalDirection = TraversalDirection.SCATTER
               ) -> Frontier:
    """reference frontier.h set_all_active(); the neighbour count saturates
    at int32 max, as the reference package's does without 64-bit mode."""
    dev = graph.device
    mask = torch.arange(graph.v_pad, dtype=torch.int32, device=dev) < graph.v
    return Frontier(mask=mask, size=_i32(graph.v, dev),
                    neighbours_count=_i32(min(graph.e, 2**31 - 1), dev),
                    direction=direction, sparsity=Sparsity.ALL_ACTIVE)


def from_mask(graph: VGLGraph, mask: torch.Tensor,
              direction: TraversalDirection,
              sparsity: Sparsity = Sparsity.DENSE) -> Frontier:
    dg = graph.direction(direction)
    ids = torch.arange(graph.v_pad, dtype=torch.int32, device=mask.device)
    m = mask & (ids < graph.v)
    size = torch.sum(m, dtype=torch.int32)
    nbr = torch.sum(torch.where(m, dg.degrees, 0), dtype=torch.int32)
    return Frontier(mask=m, size=size, neighbours_count=nbr,
                    direction=direction, sparsity=sparsity)


def from_vertex(graph: VGLGraph, vertex_original_id,
                direction: TraversalDirection = TraversalDirection.SCATTER
                ) -> Frontier:
    """Single-source frontier (reference frontier.h add_vertex); takes the
    ORIGINAL vertex id and places it in the direction's sorted ordering."""
    dg = graph.direction(direction)
    mask = torch.zeros(graph.v_pad, dtype=torch.bool, device=graph.device)
    mask[dg.orig_to_sorted[vertex_original_id].long()] = True
    return from_mask(graph, mask, direction, Sparsity.SPARSE)


def compact_ids(frontier: Frontier,
                capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Compacted active ids padded to `capacity` (static). Returns (ids,
    valid): ids int32 [capacity], ascending active ids then v_pad;
    valid[j] = j < frontier.size. Active ids beyond `capacity` are dropped
    (the overflow contract). One sort of keyed ids, as in the reference
    (the analog of vector_copy_if_indexes, copy_if.hpp:12-90), so nothing
    is read back to the host."""
    v_pad = frontier.mask.shape[0]
    dev = frontier.mask.device
    idx = torch.arange(v_pad, dtype=torch.int32, device=dev)
    keys = torch.where(frontier.mask, idx, v_pad)
    ids = torch.sort(keys).values[:capacity]
    if capacity > v_pad:      # keep ids capacity-long
        ids = torch.cat([ids, ids.new_full((capacity - v_pad,), v_pad)])
    valid = torch.arange(capacity, dtype=torch.int32,
                         device=dev) < frontier.size
    return ids, valid


def classify_sparsity(active_ratio: float, cfg_dense_threshold: float) -> Sparsity:
    """Host-side sparsity classification (reference GNF threshold switch,
    nec/generate_new_frontier.hpp:246-306)."""
    if active_ratio >= 1.0:
        return Sparsity.ALL_ACTIVE
    if active_ratio >= cfg_dense_threshold:
        return Sparsity.DENSE
    return Sparsity.SPARSE
