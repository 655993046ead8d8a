"""HITS (hubs & authorities; port of vectorgraphlibrary_tpu/models/hits.py).

Capability match for the reference HITS (`algorithms/hits/hits.hpp:5-176`):
alternating gather phases — auth[v] = Σ hub[u] over incoming edges, hub[v] =
Σ auth[w] over outgoing edges — each followed by L2 normalization. Both
phases are pulls (the hub phase pulls over the outgoing container): the auth
phase consumes hub in SCATTER order and produces auth in GATHER order, the
hub phase consumes that and produces hub in SCATTER order, so the loop
carries (hub_s, auth_g) and each pull takes its input in the source side's
ordering (`src_in_src_order`). Per iteration that is two CSR pull kernel
launches and two vertex routes (the port reorders the input before each
pull); the loop is an eager host loop that reads nothing back.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import TraversalDirection
from ..graph.device import VGLGraph
from ..graph.vertices import VertexArray
from ..ops.advance import advance_pull_value
from . import common

S, G, O = (TraversalDirection.SCATTER, TraversalDirection.GATHER,
           TraversalDirection.ORIGINAL)


def _hits_run(graph: VGLGraph, iterations: int):
    v = graph.v
    zero = torch.zeros((), dtype=torch.float32, device=graph.device)
    real_s = graph.outgoing.sorted_to_orig < v
    real_g = graph.incoming.sorted_to_orig < v
    hub_s = real_s.to(torch.float32)
    auth_g = real_g.to(torch.float32)

    def normalize(x):
        n = torch.sqrt(torch.sum(x * x))
        return torch.where(n > 0, x / n, x)

    for _ in range(iterations):
        auth_new = advance_pull_value(graph, hub_s, "add", direction=G,
                                      src_in_src_order=True)
        auth_g = normalize(torch.where(real_g, auth_new, zero))
        hub_new = advance_pull_value(graph, auth_g, "add", direction=S,
                                     src_in_src_order=True)
        hub_s = normalize(torch.where(real_s, hub_new, zero))

    auth = common.to_direction(graph, auth_g, G, O)
    hub = common.to_direction(graph, hub_s, S, O)
    real_o = torch.arange(graph.v_pad, dtype=torch.int32,
                          device=graph.device) < v
    return torch.where(real_o, auth, zero), torch.where(real_o, hub, zero)


def vgl_hits(graph: VGLGraph, iterations: int = 20
             ) -> tuple[VertexArray, VertexArray]:
    auth, hub = _hits_run(graph, iterations)
    return (VertexArray(values=auth, direction=O),
            VertexArray(values=hub, direction=O))


def seq_hits(ec, iterations: int = 20) -> tuple[np.ndarray, np.ndarray]:
    """Sequential oracle: the fp64 math of the JAX package's oracle, with
    np.bincount(weights=) in place of np.add.at, which is slow on large
    graphs. bincount adds the edges' terms in edge order too, so the sums
    are the same."""
    v = ec.vertices_count
    auth = np.ones(v)
    hub = np.ones(v)
    for _ in range(iterations):
        a = np.bincount(ec.dst_ids, weights=hub[ec.src_ids], minlength=v)
        n = np.linalg.norm(a)
        auth = a / n if n > 0 else a
        h = np.bincount(ec.src_ids, weights=auth[ec.dst_ids], minlength=v)
        n = np.linalg.norm(h)
        hub = h / n if n > 0 else h
    return auth.astype(np.float32), hub.astype(np.float32)
