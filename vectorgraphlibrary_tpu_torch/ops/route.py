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
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

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
    assert x.shape == (plan.n,), (tuple(x.shape), plan.n)
    flags = None
    if finish is not None:
        flags = plan.flags_inv if inverse else plan.flags_fwd
        assert flags is not None, "plan built without finish flags"
        assert (weights is not None) == (finish.weight_op is not None)
    is_bool = x.dtype == torch.bool
    if is_bool:
        x = x.to(torch.int32)
    out = route_gather_finish(
        x, plan.inv_idx if inverse else plan.fwd_idx, flags=flags,
        weights=weights,
        weight_op=None if finish is None else finish.weight_op,
        exclude_self_loops=finish is not None and finish.exclude_self_loops,
        ident=0 if finish is None else finish.ident)
    if is_bool and finish is None:
        out = out.to(torch.bool)
    return out
