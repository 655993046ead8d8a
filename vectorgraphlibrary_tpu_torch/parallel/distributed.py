"""Distributed algorithm steps over the 2-D (edge x vertex) mesh (port of
vectorgraphlibrary_tpu/parallel/distributed.py).

Each step is the multi-rank form of a single-card primitive chain:
edge-parallel messages from this rank's edges, scattered into its owned
vertex range, merged over the edge axis (all-reduce) after the full state
was gathered over the vertex axis (all-gather): the collective pattern
that replaces the reference's MPI exchange (SURVEY.md §2.4.5). A step
takes and returns this rank's range of the state ([v_pad / n_v]) and is
called by every rank of the mesh together.
"""
from __future__ import annotations

from typing import Callable

import torch

from . import collectives as C
from .edge_shard import ShardedEdgeGraph
from .mesh import Mesh

_INF_I32 = torch.iinfo(torch.int32).max


def _take(x: torch.Tensor, idx: torch.Tensor, fill) -> torch.Tensor:
    """x[idx], `fill` where idx is out of range (jnp.take mode="fill")."""
    inside = idx < x.shape[0]
    return torch.where(inside, x[idx.clamp(max=x.shape[0] - 1).long()], fill)


def make_pr_step(graph: ShardedEdgeGraph, mesh: Mesh,
                 damping: float = 0.85) -> Callable:
    """One distributed PageRank power iteration: ranks_local -> ranks_local."""
    v, v_pad = graph.v, graph.v_pad
    v_local = v_pad // mesh.n_vertex
    k = (1.0 - damping) / v
    dev = graph.src.device
    outdeg = graph.out_degrees
    rev = torch.where(outdeg > 0, 1.0 / outdeg.to(torch.float32), 0.0)
    dangling_mask = (outdeg == 0) & (torch.arange(v_pad, device=dev) < v)
    loop = graph.src == graph.dst
    real = mesh.v_index * v_local + torch.arange(v_local, device=dev) < v

    def step(ranks_local: torch.Tensor) -> torch.Tensor:
        ranks = C.gather_private(ranks_local, mesh.v_group)
        dangling = torch.sum(torch.where(dangling_mask, ranks, 0.0)) / v
        msg = torch.where(loop, 0.0, _take(ranks * rev, graph.src, 0.0))
        acc = C.scatter_to_owner(msg, graph.dst, v_local, mesh.v_group, "add")
        acc = C.merge_all(acc, "add", mesh.e_group)
        return torch.where(real, k + damping * (acc + dangling), 0.0)
    return step


def make_sssp_step(graph: ShardedEdgeGraph, mesh: Mesh) -> Callable:
    """One distributed Bellman-Ford relaxation: dist_local -> dist_local."""
    v_local = graph.v_pad // mesh.n_vertex

    def step(dist_local: torch.Tensor) -> torch.Tensor:
        dist = C.gather_private(dist_local, mesh.v_group)
        msg = _take(dist, graph.src, torch.inf) + graph.weights
        init = torch.full((v_local,), torch.inf, dtype=dist.dtype,
                          device=dist.device)
        cand = C.scatter_to_owner(msg, graph.dst, v_local, mesh.v_group,
                                  "min", init)
        return torch.minimum(dist_local, C.merge_all(cand, "min",
                                                     mesh.e_group))
    return step


def make_bfs_step(graph: ShardedEdgeGraph, mesh: Mesh) -> Callable:
    """One distributed BFS expansion: (levels_local, current_level) ->
    levels_local (unreached: int32 max)."""
    v_local = graph.v_pad // mesh.n_vertex

    def step(levels_local: torch.Tensor, current_level: int) -> torch.Tensor:
        levels = C.gather_private(levels_local, mesh.v_group)
        on_front = _take(levels, graph.src, _INF_I32) == current_level
        msg = torch.where(on_front, current_level + 1, _INF_I32) \
            .to(torch.int32)
        init = torch.full((v_local,), _INF_I32, dtype=torch.int32,
                          device=levels.device)
        cand = C.scatter_to_owner(msg, graph.dst, v_local, mesh.v_group,
                                  "min", init)
        return torch.minimum(levels_local, C.merge_all(cand, "min",
                                                       mesh.e_group))
    return step
