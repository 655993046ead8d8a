"""Combine monoids for edge-message aggregation (port of
vectorgraphlibrary_tpu/ops/monoid.py).

Each monoid has an identity, an elementwise combine, a reduction along one
axis, a reduction over sorted segments and a scatter (scatter_at, the sparse
push's combine, and scatter_at_, the same combine in place). Segments are
given by their lengths, which are static graph structure
(graph.device.HugeTile.seg_lengths), so no reduction has to read a device value back to the host. Float sums over
segments use torch.segment_reduce, which reduces each segment in one pass in a
fixed order: the result does not change from run to run.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .cuda.scatter_combine import (scatter_combine, scatter_combine_,
                                   scatter_reduce_drop)


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

    def _scatter_op(self, target: torch.Tensor, vals: torch.Tensor,
                    mode: str) -> tuple[str, bool]:
        """(the scatter's op, whether the card has a kernel for it on
        target's dtype); raises where scatter_at does."""
        if mode != "drop":
            raise ValueError(f"scatter_at: mode {mode!r} (only 'drop')")
        op = self.name
        if op == "any01":
            op = "max"
        if op == "or":
            if target.dtype != torch.bool and vals.dtype != torch.bool:
                raise NotImplementedError(
                    "int bitwise-or scatter: use a pull/segment formulation "
                    "(max only equals OR for {0,1} values)")
            op = "max"
        kernel = (op in ("min", "max") and target.dtype in (torch.int32,
                                                            torch.float32)) \
            or (op == "add" and target.dtype == torch.int32)
        if not kernel and target.device.type != "cpu":
            raise TypeError(f"scatter_at: no kernel for {self.name} over "
                            f"{target.dtype} on {target.device}")
        return op, kernel

    def scatter_at(self, target: torch.Tensor, idx: torch.Tensor,
                   vals: torch.Tensor, mode: str = "drop") -> torch.Tensor:
        """New tensor: `target` with vals[i] combined into target[idx[i]]
        (reference monoid.py:41-58, `target.at[idx].<op>(vals, mode="drop")`).
        add, min, max and any01 (as max) work; or works on bool (as max) and
        raises NotImplementedError on int bitmasks, as in the reference.
        mode "drop" drops every index outside [0, len(target)); JAX's would
        wrap a negative index first, and no caller passes one.

        On the card a min or max over int32 or f32, or an add over int32,
        is one scatter_combine kernel launch and any other (op, dtype)
        raises (an f32 add by atomics would not give the same bits twice);
        on the CPU every case runs in plain PyTorch (those five through the
        kernel's plain version)."""
        op, kernel = self._scatter_op(target, vals, mode)
        if kernel:
            return scatter_combine(target, idx.contiguous(),
                                   vals.to(target.dtype).contiguous(), op)
        return scatter_reduce_drop(target, idx, vals, op)

    def scatter_at_(self, target: torch.Tensor, idx: torch.Tensor,
                    vals: torch.Tensor, mode: str = "drop") -> torch.Tensor:
        """scatter_at into `target` itself, which is returned: the port's
        in-place form of the reference's `target.at[idx].<op>(vals,
        mode="drop")`, for a target the caller has just made and reads
        nowhere else. JAX's arrays are immutable; the port updates in place
        here to save the target's copy. The same cases and errors as
        scatter_at; on the card the kernel cases are one scatter_combine_
        launch into a contiguous target."""
        op, kernel = self._scatter_op(target, vals, mode)
        if kernel:
            return scatter_combine_(target, idx.contiguous(),
                                    vals.to(target.dtype).contiguous(), op)
        return target.copy_(scatter_reduce_drop(target, idx, vals, op))

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
