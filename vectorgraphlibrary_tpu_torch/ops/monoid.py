"""Combine monoids for edge-message aggregation (port of
vectorgraphlibrary_tpu/ops/monoid.py).

Each monoid has an identity, an elementwise combine, a reduction along one
axis and a reduction over sorted segments. Segments are given by their
lengths, which are static graph structure (graph.device.HugeTile.seg_lengths),
so no reduction has to read a device value back to the host. Float sums over
segments use torch.segment_reduce, which reduces each segment in one pass in a
fixed order: the result does not change from run to run.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


def _segment(reduce: str):
    """Sorted-segment reduce `reduce` in ("sum", "amin", "amax")."""
    def fn(mon, data, lengths):
        ident = mon.identity(data.dtype)
        if data.dtype.is_floating_point:
            return torch.segment_reduce(data, reduce.lstrip("a"),
                                        lengths=lengths, unsafe=True,
                                        initial=ident.item())
        # integers combine exactly in any order: scatter by segment id
        seg = torch.repeat_interleave(
            torch.arange(lengths.shape[0], device=data.device), lengths,
            output_size=data.shape[0])
        out = torch.full((lengths.shape[0],), ident.item(), dtype=data.dtype,
                         device=data.device)
        if data.dtype == torch.bool:
            return out.to(torch.int32).scatter_reduce_(
                0, seg, data.to(torch.int32), reduce).to(torch.bool)
        return out.scatter_reduce_(0, seg, data, reduce)
    return fn


def _or_reduce(a: torch.Tensor, dim: int) -> torch.Tensor:
    """Bitwise OR along `dim` by pairwise halving (torch has no OR reduce)."""
    a = a.movedim(dim, -1)
    if a.shape[-1] == 0:
        return torch.zeros(a.shape[:-1], dtype=a.dtype, device=a.device)
    while a.shape[-1] > 1:
        if a.shape[-1] % 2:
            a = torch.cat([a, torch.zeros_like(a[..., :1])], dim=-1)
        a = a[..., 0::2] | a[..., 1::2]
    return a[..., 0]


def _or_segment(mon, data, lengths):
    """OR over sorted segments, bit by bit, so words with bit 31 set are
    never compared as signed values (reference monoid.py:78-83); an empty
    segment is 0."""
    any01 = _segment("amax")
    if data.dtype == torch.bool:
        return any01(ANY01, data, lengths)
    out = torch.zeros(lengths.shape[0], dtype=data.dtype, device=data.device)
    for b in range(data.dtype.itemsize * 8):
        bit = (data >> b) & 1
        out |= any01(ANY01, bit, lengths) << b
    return out


@dataclasses.dataclass(frozen=True)
class Monoid:
    name: str
    combine: Callable                 # elementwise binary op
    _reduce_axis: Callable            # (arr, dim) -> reduced
    _segment_reduce: Callable         # (mon, data, lengths) -> arr

    def identity(self, dtype) -> torch.Tensor:
        if self.name in ("add", "or", "any01"):
            return torch.zeros((), dtype=dtype)
        if self.name == "min":
            return torch.tensor(torch.inf if dtype.is_floating_point
                                else torch.iinfo(dtype).max, dtype=dtype)
        if self.name == "max":
            if dtype == torch.bool:
                return torch.tensor(False)
            return torch.tensor(-torch.inf if dtype.is_floating_point
                                else torch.iinfo(dtype).min, dtype=dtype)
        raise ValueError(self.name)

    def reduce_axis(self, a: torch.Tensor, dim: int) -> torch.Tensor:
        return self._reduce_axis(a, dim)

    def segment_reduce(self, data: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
        """Reduce consecutive runs of `data`: segment j is the next
        lengths[j] elements (int64 lengths summing to len(data)); an empty
        segment gets the identity."""
        return self._segment_reduce(self, data, lengths)


def _sum(a, dim):
    # integer sums keep their dtype (torch.sum would widen int32 to int64)
    return a.sum(dim, dtype=a.dtype)


ADD = Monoid("add", torch.add, _sum, _segment("sum"))
MIN = Monoid("min", torch.minimum, torch.amin, _segment("amin"))
MAX = Monoid("max", torch.maximum, torch.amax, _segment("amax"))
# logical-or over bool (BFS reachability) / bitwise-or over ints (bitmasks)
OR = Monoid("or", torch.bitwise_or, _or_reduce, _or_segment)
# max over values KNOWN to be in {0,1} (identity 0): the int8 bool-pull
# reduction of advance_pull_value
ANY01 = Monoid("any01", torch.maximum, torch.amax, _segment("amax"))

MONOIDS = {"add": ADD, "min": MIN, "max": MAX, "or": OR, "any01": ANY01}


def get(name_or_monoid) -> Monoid:
    if isinstance(name_or_monoid, Monoid):
        return name_or_monoid
    return MONOIDS[name_or_monoid]
