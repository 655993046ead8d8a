"""Plain weakly connected components from the edge list: every vertex
labelled with the least vertex id of its component, by min-label hooking
over both directions of every edge and pointer jumping to a fixpoint.

The check compares partitions, not label values: a vertex whose label
differs from its component's least vertex's label splits a component, and
two components that share a label are merged; the number is both counted.
There is no lower precision of a partition (CONTROL None). Imports torch
only."""
from __future__ import annotations

import torch

CONTROL = None
LIMITS = {"cc_mismatched": 0}


def solve(src, dst, w, v: int, root, params: dict, control: bool = False):
    """Labels [v] (int64): the least vertex id of each vertex's component."""
    src, dst = src.long(), dst.long()
    labels = torch.arange(v, dtype=torch.long, device=src.device)
    while True:
        new = labels.clone()
        new.scatter_reduce_(0, dst, labels[src], "amin")
        new.scatter_reduce_(0, src, labels[dst], "amin")
        while True:
            jumped = new[new]
            if torch.equal(jumped, new):
                break
            new = jumped
        if torch.equal(new, labels):
            return labels
        labels = new


def compare(got, want) -> dict:
    """got: the labels under test [v] (any integers); want: solve's [v]."""
    got = got.to(want.device, torch.long)
    split = int((got != got[want]).sum())
    roots = torch.unique(want)
    merged = roots.numel() - torch.unique(got[roots]).numel()
    return {"cc_mismatched": split + merged}
