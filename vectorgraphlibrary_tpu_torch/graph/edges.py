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
from ..runtime.profiling import annotate
from .device import VGLGraph, synchronize


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
    """Lay COO-ordered per-edge values out per direction using the edge
    perms (the reference's edges_reorder_indexes path, import.hpp:157-165):
    flat[:e] = coo_values[edge_perm[:e]], the padding slots hold pad_value.
    h_out, h_in: the records of the graph's import, as
    graph.device.import_graph(_host_out=...) gives them
    (graph/build_torch.DeviceDirectedCSR, whose edge_perm is on the device
    of that import, which may be another than the graph's: the values are
    uploaded once and laid out on the graph's device), or the host CSRs
    (graph/build.py HostDirectedCSR of either package) that
    graph.device.from_host takes. The span ends after a device
    synchronize."""
    coo_values = np.asarray(coo_values)
    values = None               # coo_values on the device, uploaded once
    dirs = []
    with annotate("vgl.import.edge_values", keep=True):
        for h, dg in ((h_out, graph.outgoing), (h_in, graph.incoming)):
            if (h.edges_count, h.edges_pad) != (dg.e, dg.e_pad):
                raise ValueError("the records do not belong to this graph")
            e = h.edges_count
            if isinstance(h.edge_perm, torch.Tensor):
                if values is None:
                    values = torch.from_numpy(
                        np.ascontiguousarray(coo_values)).to(graph.device)
                flat = torch.full((h.edges_pad,), pad_value,
                                  dtype=values.dtype, device=graph.device)
                # the records may come from an import on another device
                flat[:e] = torch.index_select(
                    values, 0, h.edge_perm[:e].to(graph.device))
            else:
                host = np.full(h.edges_pad, pad_value, dtype=coo_values.dtype)
                host[:e] = coo_values[h.edge_perm[:e]]
                flat = torch.from_numpy(host).to(graph.device)
            dirs.append(DirectedEdgeValues(flat=flat))
        synchronize(graph.device)
    return EdgeArray(outgoing=dirs[0], incoming=dirs[1])


def edge_array_from_flat(graph: VGLGraph, flat_out: torch.Tensor,
                         flat_in: torch.Tensor, pad_value=0) -> EdgeArray:
    """EdgeArray from flat CSR-order values that are already on the device
    (e.g. updated residual capacities); there are no tile copies to
    rebuild. pad_value is taken for the reference's signature: there it
    fills the padding slots of the tile copies, which the port does not
    keep, so it changes nothing here."""
    del pad_value
    for flat, dg in ((flat_out, graph.outgoing), (flat_in, graph.incoming)):
        if flat.shape != (dg.e_pad,):
            raise ValueError(f"flat values of shape {tuple(flat.shape)} for "
                             f"{dg.e_pad} CSR slots")
    return EdgeArray(outgoing=DirectedEdgeValues(flat=flat_out),
                     incoming=DirectedEdgeValues(flat=flat_in))
