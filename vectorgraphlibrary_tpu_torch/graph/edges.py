"""EdgeArray: |E|-indexed per-edge data (weights, flow, ...) per traversal
direction (port of vectorgraphlibrary_tpu/graph/edges.py).

Capability match for the reference ``EdgesArray<T>``
(`vgl_datastructures/edges_array/edges_array.h:9-63`). Per direction the port
keeps ONE copy of the values, ``flat``, in the direction's CSR slot order:
the pull kernel (ops/cuda/pull_reduce.py) streams it beside ``col_idx`` and
the sparse push (ops/advance.advance_push_sparse) gathers it by CSR slot. The
JAX package also keeps a copy per tile (``bucket_tiles``, ``huge_tile``) and
one in route-slot order (``slot_flat``) for its tile and route kernels; no
ported caller reads those layouts, so they are not built here.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import TraversalDirection
from .device import VGLGraph


@dataclasses.dataclass(frozen=True)
class DirectedEdgeValues:
    flat: torch.Tensor               # [e_pad] values in CSR slot order


@dataclasses.dataclass(frozen=True)
class EdgeArray:
    outgoing: DirectedEdgeValues
    incoming: DirectedEdgeValues

    def direction(self, d: TraversalDirection) -> DirectedEdgeValues:
        return self.outgoing if d == TraversalDirection.SCATTER else self.incoming


def build_edge_array_from_host(coo_values: np.ndarray, graph: VGLGraph,
                               h_out, h_in, pad_value=0) -> EdgeArray:
    """Lay COO-ordered per-edge values out per direction using the host edge
    perms (the reference's edges_reorder_indexes path, import.hpp:157-165):
    flat[:e] = coo_values[edge_perm[:e]], the padding slots hold pad_value.
    h_out, h_in: the host CSRs the graph was built from (graph/build.py
    HostDirectedCSR of either package, as graph.device.from_host takes them)."""
    coo_values = np.asarray(coo_values)
    dirs = []
    for h, dg in ((h_out, graph.outgoing), (h_in, graph.incoming)):
        if (h.edges_count, h.edges_pad) != (dg.e, dg.e_pad):
            raise ValueError("host CSR does not belong to this graph")
        flat = np.full(h.edges_pad, pad_value, dtype=coo_values.dtype)
        flat[:h.edges_count] = coo_values[h.edge_perm[:h.edges_count]]
        dirs.append(DirectedEdgeValues(
            flat=torch.from_numpy(flat).to(graph.device)))
    return EdgeArray(outgoing=dirs[0], incoming=dirs[1])


def edge_array_from_flat(graph: VGLGraph, flat_out: torch.Tensor,
                         flat_in: torch.Tensor) -> EdgeArray:
    """EdgeArray from flat CSR-order values that are already on the device
    (e.g. updated residual capacities); there are no tile copies to
    rebuild."""
    for flat, dg in ((flat_out, graph.outgoing), (flat_in, graph.incoming)):
        if flat.shape != (dg.e_pad,):
            raise ValueError(f"flat values of shape {tuple(flat.shape)} for "
                             f"{dg.e_pad} CSR slots")
    return EdgeArray(outgoing=DirectedEdgeValues(flat=flat_out),
                     incoming=DirectedEdgeValues(flat=flat_in))
