"""Edge-partitioned distributed graph (port of
vectorgraphlibrary_tpu/parallel/edge_shard.py).

Each rank owns an equal padded slice of the (src, dst, weight) edge list in
ORIGINAL id space along the mesh's edge axis, plus its range of the vertex
state along the vertex axis. This replaces the reference's replicated
graph with per-rank vertex thresholds (`advance_worker.hpp:239-264`) by
true edge partitioning (SURVEY.md §7.1 "Distribution").
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..io.edges_container import EdgesContainer
from .mesh import Mesh, edge_sharded


def _round_up(x, m):
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ShardedEdgeGraph:
    """This rank's part of the COO edge list padded to n_e * a multiple of
    8: pad edges have src = v (a vertex of no rank's state) and dst =
    v_pad + 1 (out of every range, so dropped)."""

    src: torch.Tensor          # int32 [e_pad / n_e], this rank's edges
    dst: torch.Tensor          # int32 [e_pad / n_e]
    weights: torch.Tensor      # float32 [e_pad / n_e]
    out_degrees: torch.Tensor  # int32 [v_pad], replicated
    v: int = 0
    v_pad: int = 0
    e: int = 0
    e_pad: int = 0


def build_sharded_edge_graph(ec: EdgesContainer, mesh: Mesh
                             ) -> ShardedEdgeGraph:
    """This rank's ShardedEdgeGraph on mesh.device."""
    n_e, n_v = mesh.n_edge, mesh.n_vertex
    v = ec.vertices_count
    v_pad = _round_up(v, 8 * n_v)
    e_pad = _round_up(max(ec.edges_count, n_e * 8), n_e * 8)
    src = np.full(e_pad, v, np.int32)
    dst = np.full(e_pad, v_pad + 1, np.int32)
    w = np.zeros(e_pad, np.float32)
    src[:ec.edges_count] = ec.src_ids
    dst[:ec.edges_count] = ec.dst_ids
    if ec.weights is not None:
        w[:ec.edges_count] = ec.weights
    outdeg = np.zeros(v_pad, np.int32)
    outdeg[:v] = np.bincount(ec.src_ids, minlength=v)

    def part(a):
        return edge_sharded(torch.from_numpy(a), mesh).to(mesh.device)
    return ShardedEdgeGraph(
        src=part(src), dst=part(dst), weights=part(w),
        out_degrees=torch.from_numpy(outdeg).to(mesh.device),
        v=v, v_pad=v_pad, e=ec.edges_count, e_pad=e_pad)
