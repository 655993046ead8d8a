"""Label propagation (community detection) (port of
vectorgraphlibrary_tpu/models/lp.py).

Capability match for the reference LP (`algorithms/lp/lp.h:15-27`): every
round, each vertex takes the most frequent label among its in-neighbours
(parallel edges count once each, ties go to the smaller label, a vertex with
no in-edges keeps its own), until no label changes.

One round here runs over the incoming CSR in GATHER ordering: gather the
source label of every edge, sort once by the int64 key row · 2^31 + label,
take the runs of equal keys with their lengths, then two segment
reductions: the longest run of each row, and the smallest label among the
runs of that length. The reference computes the same mode per tile class
(each bucket row sorted, the huge rows by one two-key sort) and, on its
chip, from route slots (`_lp_step_routed`, because element gathers were
slow there); neither layout is needed for a CSR. The reference's tests run
its routed step, so holding the port to them also holds the two forms equal.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import TraversalDirection
from ..graph.device import VGLGraph
from ..graph.vertices import VertexArray

O = TraversalDirection.ORIGINAL
_BIG = 2**31 - 1


def _lp_step(graph: VGLGraph, labels_g: torch.Tensor):
    """One LP round in GATHER ordering: labels <- mode of in-neighbour
    labels. Returns (labels, changes as a 0-d device tensor)."""
    dg = graph.incoming
    v_pad = graph.v_pad
    e = dg.e
    degs = dg.degrees.long()
    rows = torch.repeat_interleave(
        torch.arange(v_pad, device=labels_g.device), degs, output_size=e)
    vals = labels_g[dg.col_idx[:e].long()].long()
    keys, counts = torch.unique_consecutive(torch.sort(rows * 2**31 + vals)[0],
                                            return_counts=True)
    key_rows = keys >> 31
    longest = torch.zeros(v_pad, dtype=counts.dtype, device=keys.device) \
        .scatter_reduce_(0, key_rows, counts, "amax")
    best = torch.where(counts == longest[key_rows], keys & _BIG, _BIG)
    mode = torch.full((v_pad,), _BIG, dtype=torch.int64, device=keys.device) \
        .scatter_reduce_(0, key_rows, best, "amin")
    new = torch.where(degs > 0, mode.to(torch.int32), labels_g)
    return new, torch.sum(new != labels_g, dtype=torch.int32)


def vgl_label_propagation(graph: VGLGraph, max_iterations: int = 20
                          ) -> tuple[VertexArray, int]:
    """Labels start as ORIGINAL vertex ids (padding _BIG); returns the labels
    in ORIGINAL ordering and the count of rounds run, as the reference's
    loop counts them (the round that changed nothing included)."""
    dg = graph.incoming
    ids = torch.arange(graph.v_pad, dtype=torch.int32, device=graph.device)
    labels_o = torch.where(ids < graph.v, ids, _BIG)
    labels = labels_o[dg.sorted_to_orig.long()]
    it = 0
    for it in range(1, max_iterations + 1):
        labels, changes = _lp_step(graph, labels)
        if int(changes) == 0:
            break
    out = labels[dg.orig_to_sorted.long()]
    return VertexArray(values=out, direction=O), it


def seq_label_propagation(ec, max_iterations: int = 20) -> np.ndarray:
    """Sequential oracle with the same synchronous mode semantics (mode over
    in-neighbours, ties to the smaller label, keep the own label without
    in-neighbours): a Python loop over the vertices, as in the reference."""
    v = ec.vertices_count
    labels = np.arange(v, dtype=np.int64)
    # multiplicity preserved: parallel edges weight the mode
    order = np.argsort(ec.dst_ids, kind="stable")
    indices = ec.src_ids[order]
    counts = np.bincount(ec.dst_ids, minlength=v)
    indptr = np.concatenate([[0], np.cumsum(counts)])
    for _ in range(max_iterations):
        new = labels.copy()
        for u in range(v):
            nb = labels[indices[indptr[u]:indptr[u + 1]]]
            if len(nb) == 0:
                continue
            vals, counts = np.unique(nb, return_counts=True)
            new[u] = vals[np.argmax(counts)]
        if np.array_equal(new, labels):
            break
        labels = new
    return labels.astype(np.int32)


def seq_label_propagation_fast(ec, max_iterations: int = 20) -> np.ndarray:
    """seq_label_propagation vectorised for large graphs: per round one sort
    of the edges' (destination, source label) keys, packed into one int64
    (destination * v + label: labels are vertex ids below v), the runs of
    equal keys, and per destination the smallest label among its longest
    runs. Equal to the loop version (tests/test_torch_lp.py)."""
    v = ec.vertices_count
    labels = np.arange(v, dtype=np.int64)
    dst_key = ec.dst_ids.astype(np.int64) * v
    if ec.edges_count == 0:
        return labels.astype(np.int32)
    for _ in range(max_iterations):
        key = np.sort(dst_key + labels[ec.src_ids])
        start = np.ones(len(key), bool)
        start[1:] = key[1:] != key[:-1]
        first = np.flatnonzero(start)
        run_d, run_lab = np.divmod(key[first], v)
        run_len = np.diff(np.append(first, len(key)))
        # runs are sorted by destination: reduce each destination's runs
        row = np.flatnonzero(np.diff(run_d, prepend=-1))
        longest = np.maximum.reduceat(run_len, row)
        is_best = run_len == np.repeat(longest, np.diff(np.append(row,
                                                                  len(run_d))))
        mode = np.minimum.reduceat(
            np.where(is_best, run_lab, np.iinfo(np.int64).max), row)
        new = labels.copy()
        new[run_d[row]] = mode
        if np.array_equal(new, labels):
            break
        labels = new
    return labels.astype(np.int32)
