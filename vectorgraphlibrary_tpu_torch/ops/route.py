"""Static slot routes: move per-slot values between two fixed orderings.

Port of vectorgraphlibrary_tpu/ops/route.py and the route contract of
ops/pallas/route_fused.py. The reference executes a permutation fixed at
import time as a Beneš network of masked exchange stages, because per-element
gathers were the slow operation on its chip. On a GPU a static permutation is
one indexed load per slot, so a plan here is just the gather index of each
direction:

    forward   y = x[perm]         y[i] = x[fwd_idx[i]],  fwd_idx = perm
    inverse   y[perm] = x         y[i] = x[inv_idx[i]],  inv_idx = argsort(perm)

plus the optional per-slot flag bytes of the fused advance finish (bit0 = slot
holds a real edge, bit1 = that edge is a self-loop), indexed by each
direction's OUTPUT slot. The output equals the reference route's bit for bit.

A persisted graph stores its routes as Beneš networks, not permutations
(graph/persistence.py). `BenesPlan` and `apply_route_stages` execute such a
network stage by stage, as the reference's XLA path does (route.py:72-198
there), with the middle lane shuffle as a kernel; `plan_from_benes` runs it
once per direction over arange(n) to recover the gather indices.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..runtime.profiling import annotate
from .cuda.lane_shuffle import lane_shuffle
from .cuda.route_gather import route_gather_finish


@dataclasses.dataclass(frozen=True)
class FinishSpec:
    """Epilogue fused into the route (the restricted edge_op of the hot
    advance): x' = wop(x, w); out = valid ? x' : ident, where valid/self-loop
    are the per-slot flag bits of the plan (reference route_fused.FinishSpec)."""

    ident: float                       # combine monoid identity (mask value)
    exclude_self_loops: bool = False   # also mask slots flagged self-loop
    weight_op: Optional[str] = None    # None | 'add' | 'min' | 'max' | 'mul'


@dataclasses.dataclass(frozen=True)
class RoutePlan:
    n: int
    fwd_idx: torch.Tensor                     # int32 [n]: perm
    inv_idx: torch.Tensor                     # int32 [n]: argsort(perm)
    flags_fwd: Optional[torch.Tensor] = None  # uint8 [n], forward output order
    flags_inv: Optional[torch.Tensor] = None  # uint8 [n], inverse output order


def make_route_plan(perm: np.ndarray, flags_fwd: Optional[np.ndarray] = None,
                    flags_inv: Optional[np.ndarray] = None,
                    device="cuda") -> RoutePlan:
    """Host: the gather indices of y = x[perm] and of its inverse."""
    perm = np.asarray(perm, np.int64)
    n = len(perm)
    if n >= 2**31:
        raise ValueError(f"route of {n} slots exceeds int32 gather indices")
    if n and (perm.min() < 0 or perm.max() >= n):
        raise ValueError("perm holds values outside range(n)")
    inv = np.full(n, -1, np.int64)
    inv[perm] = np.arange(n)
    if (inv < 0).any():
        raise ValueError("perm is not a permutation of range(n)")

    def up(a, dtype):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a, dtype)).to(device)
    return RoutePlan(n=n, fwd_idx=up(perm, np.int32), inv_idx=up(inv, np.int32),
                     flags_fwd=up(flags_fwd, np.uint8),
                     flags_inv=up(flags_inv, np.uint8))


def apply_route(plan: RoutePlan, x: torch.Tensor, inverse: bool = False,
                finish: Optional[FinishSpec] = None,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y[i] = x[perm[i]] (forward) or y[perm[i]] = x[i] (inverse), with the
    optional fused finish (`weights`: per-output-slot values for
    finish.weight_op). One launch of the route-gather kernel on the card."""
    with annotate("vgl.route"):
        assert x.shape == (plan.n,), (tuple(x.shape), plan.n)
        flags = None
        if finish is not None:
            flags = plan.flags_inv if inverse else plan.flags_fwd
            assert flags is not None, "plan built without finish flags"
            assert (weights is not None) == (finish.weight_op is not None)
        is_bool = x.dtype == torch.bool
        if is_bool:
            # the kernel moves bools as their bytes (0 or 1 in PyTorch): a
            # view, no cast and no copy
            x = x.view(torch.int8)
        out = route_gather_finish(
            x, plan.inv_idx if inverse else plan.fwd_idx, flags=flags,
            weights=weights,
            weight_op=None if finish is None else finish.weight_op,
            exclude_self_loops=finish is not None
            and finish.exclude_self_loops,
            ident=0 if finish is None else finish.ident)
        if is_bool and finish is None:
            out = out.view(torch.bool)
        return out


@dataclasses.dataclass(frozen=True)
class BenesPlan:
    """A route as a Beneš network (the reference RoutePlan's stage-by-stage
    encoding): y = x[perm] is `levels` masked exchanges at row distances
    n/2 ... 128, one shuffle inside each 128-lane row, and the output
    exchanges back up; the inverse runs the stages in reverse order with
    the inverse shuffle."""

    in_masks: torch.Tensor    # uint8 [levels, n // 8], little-endian bits
    out_masks: torch.Tensor   # uint8 [levels, n // 8]
    lane_idx: torch.Tensor    # int32 [n // 128, 128], forward shuffle
    lane_inv: torch.Tensor    # int32 [n // 128, 128], inverse shuffle
    n: int
    levels: int


def inverse_lanes(lane2d: np.ndarray) -> np.ndarray:
    """Per-row inverse of a [rows, 128] lane shuffle (reference
    route.py:84-87)."""
    inv = np.empty_like(lane2d)
    np.put_along_axis(inv, lane2d, np.broadcast_to(
        np.arange(128, dtype=lane2d.dtype), lane2d.shape), axis=1)
    return inv


def pack_masks(masks: np.ndarray) -> np.ndarray:
    """uint8 [levels, n] of 0/1 -> uint8 [levels, n // 8], little-endian
    bits within each byte (the reference's stage-mask encoding)."""
    return np.packbits(masks, axis=1, bitorder="little")


def make_benes_plan(perm: np.ndarray, device="cuda") -> BenesPlan:
    """Host: run the Beneš router on perm (|perm| = 2^k >= 128) and pack its
    masks (reference make_route_plan, route.py:82-87)."""
    from .. import native
    in_m, out_m, lane = native.benes_route(perm)
    lane2d = lane.reshape(-1, 128)
    return benes_plan_from_packed(pack_masks(in_m), pack_masks(out_m), lane2d,
                                  inverse_lanes(lane2d), device)


def benes_plan_from_packed(in_masks: np.ndarray, out_masks: np.ndarray,
                           lane_idx: np.ndarray, lane_inv: np.ndarray,
                           device="cuda") -> BenesPlan:
    """BenesPlan from bit-packed masks as a file stores them; checks the
    shapes and types against each other."""
    n = lane_idx.size
    levels = n.bit_length() - 1 - 7
    if n < 128 or n & (n - 1):
        raise ValueError(f"route of {n} slots: not a power of two >= 128")
    for name, a, shape, dtype in (
            ("in_masks", in_masks, (levels, n // 8), np.uint8),
            ("out_masks", out_masks, (levels, n // 8), np.uint8),
            ("lane_idx", lane_idx, (n // 128, 128), np.int32),
            ("lane_inv", lane_inv, (n // 128, 128), np.int32)):
        if a.shape != shape or a.dtype != dtype:
            raise ValueError(f"{name}: {a.dtype} {a.shape}, expected "
                             f"{np.dtype(dtype)} {shape} for n = {n}")
    for name, a in (("lane_idx", lane_idx), ("lane_inv", lane_inv)):
        if a.min() < 0 or a.max() >= 128:
            raise ValueError(f"{name} holds values outside [0, 128)")

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return BenesPlan(in_masks=up(in_masks), out_masks=up(out_masks),
                     lane_idx=up(lane_idx), lane_inv=up(lane_inv), n=n,
                     levels=levels)


def _unpack_bits(packed: torch.Tensor, n: int) -> torch.Tensor:
    """uint8 [n//8] -> bool [n], little-endian bit order within each byte."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    return ((packed[:, None] >> shifts) & 1).reshape(n).bool()


def _exchange(x: torch.Tensor, packed_mask: torch.Tensor,
              d: int) -> torch.Tensor:
    """y[i] = x[i ^ d] where the mask bit is set, else x[i]."""
    x3 = x.reshape(-1, 2, d)
    m3 = _unpack_bits(packed_mask, x.shape[0]).reshape(-1, 2, d)
    return torch.where(m3, x3.flip(1), x3).reshape(-1)


def apply_route_stages(plan: BenesPlan, x: torch.Tensor,
                       inverse: bool = False) -> torch.Tensor:
    """y[i] = x[perm[i]] (forward) or y[perm[i]] = x[i] (inverse), stage by
    stage in the reference's order (route.py:186-197). One launch of the
    lane-shuffle kernel on the card; the exchanges are torch ops, as they
    are XLA ops in the reference."""
    if x.shape != (plan.n,):
        raise ValueError(f"x of shape {tuple(x.shape)} for a route of "
                         f"{plan.n} slots")
    k = plan.n.bit_length() - 1
    first, last = ((plan.out_masks, plan.in_masks) if inverse
                   else (plan.in_masks, plan.out_masks))
    for lev in range(plan.levels):
        x = _exchange(x, first[lev], 1 << (k - 1 - lev))
    x = lane_shuffle(x.reshape(-1, 128),
                     plan.lane_inv if inverse else plan.lane_idx).reshape(-1)
    for lev in range(plan.levels - 1, -1, -1):
        x = _exchange(x, last[lev], 1 << (k - 1 - lev))
    return x


def plan_from_benes(bplan: BenesPlan, flags_fwd: Optional[np.ndarray] = None,
                    flags_inv: Optional[np.ndarray] = None,
                    device="cuda") -> RoutePlan:
    """The gather-index RoutePlan of a Beneš network: arange(n) routed
    forward is perm, routed inverse is argsort(perm), on `device` (bplan's
    tensors must lie there). Raises if the two are not inverse permutations
    of each other (a corrupt plan)."""
    device = torch.device(device)
    iota = torch.arange(bplan.n, dtype=torch.int32, device=device)
    fwd = apply_route_stages(bplan, iota)
    inv = apply_route_stages(bplan, iota, inverse=True)
    if not torch.equal(fwd[inv.long()], iota):
        raise ValueError("route plan is corrupt: its forward and inverse "
                         "routes are not inverse permutations")

    def up(a):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a, np.uint8)).to(device)
    return RoutePlan(n=bplan.n, fwd_idx=fwd, inv_idx=inv,
                     flags_fwd=up(flags_fwd), flags_inv=up(flags_inv))
