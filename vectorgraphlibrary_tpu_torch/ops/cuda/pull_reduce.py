"""The CSR pull kernel: wrapper, plain PyTorch version and launch count.

`pull_reduce(row_ptr, col_idx, x, op)` computes, for every row v,

    out[v] = op over k in [row_ptr[v], row_ptr[v+1]) of wop(x[col_idx[k]], w[k])

skipping k with col_idx[k] == v when exclude_self_loops, and the identity of
op for an empty row; op in {add, min, max, or, any01} (any01: max with
identity 0, the bool pull's "or" over {0, 1}). `weights` (w, one value per
CSR slot, f32 or i32 like x) and `weight_op` (wop in {add, min, max, mul})
come together or not at all; without them the message is x[col_idx[k]]. min
with weight add is the SSSP relaxation, max with weight min the widest-path
one. It is the advance pull
(ops/advance.advance_pull_value) in one call, in place of the route chain
that ran the reference's route kernels (vectorgraphlibrary_tpu/ops/pallas/
route_fused.py: _mid_kernel, _big_kernel, _finish).

`plan` gives the kernel its schedule (csrc/pull_reduce.cu): the CSR's n row
ends and e slots taken as one sorted sequence of n + e items, cut into tiles
of TILE items, one per block, so that edges and rows are balanced together.
`make_plan(row_ptr)` makes it with one search over row_ptr (on row_ptr's
device, two reads of a count back to the host); a caller that pulls over one
CSR many times makes it once and keeps it (ops/advance.pull_plan keeps it
with the graph). The plan is a function of row_ptr alone, so a kept one and
one made for the call give the same bits; without one the wrapper makes a
plan for the call.

What bounds the kernel is how many of its random reads of x the card's L1
serves (csrc/pull_reduce.cu). An x of up to X_IN_L1_BYTES is read through
L1 whole; a larger f32 or int32 one only in its first L1_COLS entries, the
graph's highest-degree vertices, and past L1 elsewhere, so that those stay.
On an H100 80GB HBM3 at 700 W an f32 add pull takes 0.0379 ms over
RMAT-18's GATHER CSR without self-loops and 0.0839 over RMAT-20's, against
0.0564 and 0.1279 for torch.mv of the same CSR (chip_smoke.py, CUDA
events).

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the hand-written kernel (built by nvcc for sm_90a at first use) or
raises. There is no fallback from one to the other.

`segment_reduce(row_ptr, x, op, plan)` is the same kernel's entry without
col_idx: out[v] = op over k in row v of x[k], x one message per CSR slot.
It reduces the per-edge messages of the general advance
(ops/advance.advance_pull) over the direction's rows, with the same ops,
types, schedule and fixed order, and keeps its own launch count.

Each call runs two device kernels when some row crosses a tile boundary:
the tiles, then a small one that combines each such row's per-tile values
in tile order. `launches` counts wrapper calls.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from .. import monoid as M
from . import build, f32_order

TILE = 1280                 # csrc/pull_reduce.cu kTile: merge items per block
# a 4-byte x larger than this reads only its first L1_COLS entries through
# L1 (csrc/pull_reduce.cu)
X_IN_L1_BYTES = 2 << 20
L1_COLS = 1 << 15
_OPS = {"add": 0, "min": 1, "max": 2, "or": 3, "any01": 2}
_WOPS = {None: 0, "add": 1, "min": 2, "max": 3, "mul": 4}
_JOIN = {"add": torch.add, "min": f32_order.minimum,
         "max": f32_order.maximum, "mul": torch.mul}
_P, _I = ctypes.c_void_p, ctypes.c_int
# row_ptr, col_idx, x, weights, weight op, hot columns, out, tiles, n_tiles,
# fix, n_fix, carry, exclude_self_loops, op, ident
_LAUNCH = {dtype: build.Launcher(name, _P, _P, _P, _P, _I, _I, _P, _P, _I, _P,
                                 _I, _P, _I, _I, ident_t)
           for dtype, name, ident_t in (
               (torch.float32, "vgl_pull_reduce_f32", ctypes.c_float),
               (torch.int32, "vgl_pull_reduce_i32", _I),
               (torch.int8, "vgl_pull_reduce_i8", _I))}
# row_ptr, x, out, tiles, n_tiles, fix, n_fix, carry, op, ident
_SEGMENT = {dtype: build.Launcher(name, _P, _P, _P, _P, _I, _P, _I, _P, _I,
                                  ident_t)
            for dtype, name, ident_t in (
                (torch.float32, "vgl_segment_reduce_f32", ctypes.c_float),
                (torch.int32, "vgl_segment_reduce_i32", _I),
                (torch.int8, "vgl_segment_reduce_i8", _I))}


def _check_weights(weights, weight_op) -> None:
    if weight_op not in _WOPS:
        raise ValueError(f"unknown pull_reduce weight_op {weight_op!r}")
    if (weights is None) != (weight_op is None):
        raise ValueError("pull_reduce: weights must be given exactly when "
                         "weight_op is")


def pull_reduce_ref(row_ptr: torch.Tensor, col_idx: torch.Tensor,
                    x: torch.Tensor, op: str,
                    exclude_self_loops: bool = False,
                    weights: Optional[torch.Tensor] = None,
                    weight_op: Optional[str] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arguments but the plan,
    same result; f32 sums in another order): one gather of the edges'
    values, each joined to its edge's weight, self-loops set to the
    identity, one sorted-segment reduction per row."""
    _check_weights(weights, weight_op)
    mon = M.get(op)
    n = row_ptr.shape[0] - 1
    degs = (row_ptr[1:] - row_ptr[:-1]).long()
    e = int(row_ptr[-1])              # col_idx is padded past e
    cols = col_idx[:e]
    vals = x[cols.long()]
    if weight_op is not None:
        vals = _JOIN[weight_op](vals, weights[:e])
    if exclude_self_loops:
        rows = torch.repeat_interleave(torch.arange(n, device=x.device), degs,
                                       output_size=e)
        vals = torch.where(cols == rows, mon.identity(x.dtype).to(x.device),
                           vals)
    return _segments(mon, vals, degs)


def _segments(mon, vals: torch.Tensor, degs: torch.Tensor) -> torch.Tensor:
    """mon's reduction of vals over rows of degs entries; an f32 min or max
    by the port's one f32 rule (f32_order), as the kernel's."""
    if vals.dtype == torch.float32 and mon.name in ("min", "max"):
        return f32_order.segment_reduce(vals, degs, mon.name,
                                        mon.identity(vals.dtype).item())
    return mon.segment_reduce(vals, degs)


class Plan(NamedTuple):
    """The kernel's schedule over one CSR (module doc). tiles: int32
    [n_tiles + 1, 2], the (row, slot) at which each tile starts, then (n,
    e); fix: int32 [n_fix, 2], (tile b, tile bs) for each row that ends in
    tile b but began in tile bs < b; row_ptr: the CSR's, which the wrappers
    check the plan against."""
    row_ptr: torch.Tensor
    tiles: torch.Tensor
    fix: torch.Tensor
    n_tiles: int
    n_fix: int


def make_plan(row_ptr: torch.Tensor) -> Plan:
    """The merge-path schedule of row_ptr (int32 [n+1]) for the kernel, on
    row_ptr's device: row v's end is item row_ptr[v+1] - row_ptr[0] + v of
    the n + e, so after d items the rows whose end item lies before d have
    ended and d minus their count slots are taken."""
    n = row_ptr.shape[0] - 1
    dev = row_ptr.device
    rp = row_ptr.long()
    rel = rp - rp[0]
    ends = rel[1:] + torch.arange(1, n + 1, device=dev)
    total = int(ends[-1]) if n else 0
    n_tiles = -(-total // TILE)
    d = torch.clamp(torch.arange(n_tiles + 1, device=dev) * TILE, max=total)
    rows = torch.searchsorted(ends, d, right=True)
    slots = d - rows
    tiles = torch.stack([rows, slots + rp[0]], 1).to(torch.int32)
    r = rows[:-1]
    cut = (rows[1:] > r) & (rel[r] < slots[:-1])
    b = torch.nonzero(cut).flatten()
    # the tile that holds the row's first slot, item rel[v] + v
    start = torch.div(rel[r[b]] + r[b], TILE, rounding_mode="floor")
    fix = torch.stack([b, start], 1).to(torch.int32)
    return Plan(row_ptr, tiles.contiguous(), fix.contiguous(), n_tiles,
                fix.shape[0])


def _launch_plan(name: str, row_ptr: torch.Tensor,
                 plan: Optional[Plan]) -> tuple:
    """(plan, carry scratch or None) for one launch over row_ptr."""
    if plan is None:
        plan = make_plan(row_ptr)
    elif plan.row_ptr is not row_ptr:
        raise ValueError(f"{name}: the plan was made for another row_ptr")
    carry = (torch.empty(2 * plan.n_tiles, dtype=torch.int32,
                         device=row_ptr.device) if plan.n_fix else None)
    return plan, carry


def pull_reduce(row_ptr: torch.Tensor, col_idx: torch.Tensor, x: torch.Tensor,
                op: str, exclude_self_loops: bool = False,
                plan: Optional[Plan] = None,
                weights: Optional[torch.Tensor] = None,
                weight_op: Optional[str] = None) -> torch.Tensor:
    """out[v] = op of the messages over row v's columns (module doc).

    row_ptr: int32 [n+1]; col_idx: int32 with every column in [0, len(x)),
    which the kernel does not check; x: f32, i32 or int8 (or needs an
    integer type); plan: make_plan(row_ptr), kept by the caller, or None
    to make one for this call; weights: x's dtype (f32 or i32), as long as col_idx, iff weight_op."""
    if op not in _OPS:
        raise ValueError(f"unknown pull_reduce op {op!r}")
    _check_weights(weights, weight_op)
    if weights is not None and weights.shape != col_idx.shape:
        raise ValueError(f"pull_reduce: weights of shape "
                         f"{tuple(weights.shape)} for col_idx of shape "
                         f"{tuple(col_idx.shape)}")
    if not x.is_cuda:
        if x.device.type == "cpu":
            return pull_reduce_ref(row_ptr, col_idx, x, op, exclude_self_loops,
                                   weights, weight_op)
        raise ValueError(f"pull_reduce: no kernel for {x.device}")
    launch = _LAUNCH.get(x.dtype)
    if launch is None or x.dim() != 1 or not x.is_contiguous():
        raise TypeError(f"pull_reduce: x must be a contiguous 1-D f32, i32 or "
                        f"int8 tensor, got {x.dtype} of shape {tuple(x.shape)}")
    if op == "or" and x.dtype.is_floating_point:
        raise TypeError("pull_reduce: or needs an integer type")
    dev = x.get_device()
    for name, t in (("row_ptr", row_ptr), ("col_idx", col_idx)):
        if t.dtype != torch.int32 or t.dim() != 1 or t.get_device() != dev \
                or not t.is_contiguous():
            raise ValueError(f"pull_reduce: {name} must be a contiguous 1-D "
                             f"int32 tensor on {x.device}")
    if weights is not None:
        if x.dtype == torch.int8:
            raise TypeError("pull_reduce: no edge weights with int8 values")
        if weights.dtype != x.dtype or weights.shape != col_idx.shape \
                or weights.get_device() != dev or not weights.is_contiguous():
            raise ValueError(f"pull_reduce: weights must be a contiguous "
                             f"{x.dtype} tensor of shape "
                             f"{tuple(col_idx.shape)} on {x.device}")
    plan, carry = _launch_plan("pull_reduce", row_ptr, plan)
    ident = M.get(op).identity(x.dtype).item()
    out = torch.empty(row_ptr.shape[0] - 1, dtype=x.dtype, device=x.device)
    hot = L1_COLS if x.element_size() == 4 \
        and x.numel() * 4 > X_IN_L1_BYTES else -1
    launch(dev, row_ptr.data_ptr(), col_idx.data_ptr(), x.data_ptr(),
           None if weights is None else weights.data_ptr(), _WOPS[weight_op],
           hot, out.data_ptr(), plan.tiles.data_ptr(), plan.n_tiles,
           plan.fix.data_ptr(), plan.n_fix,
           None if carry is None else carry.data_ptr(),
           int(bool(exclude_self_loops)), _OPS[op], ident)
    pull_reduce.launches += 1
    return out


pull_reduce.launches = 0


def segment_reduce_ref(row_ptr: torch.Tensor, x: torch.Tensor,
                       op: str) -> torch.Tensor:
    """Plain PyTorch version of the segment-reduce entry (same result; f32
    sums in another order): Monoid.segment_reduce of x's first row_ptr[-1]
    slots over the rows' lengths."""
    degs = (row_ptr[1:] - row_ptr[:-1]).long()
    return _segments(M.get(op), x[:int(row_ptr[-1])], degs)


def segment_reduce(row_ptr: torch.Tensor, x: torch.Tensor, op: str,
                   plan: Optional[Plan] = None) -> torch.Tensor:
    """out[v] = op over k in [row_ptr[v], row_ptr[v+1]) of x[k] (module
    doc): the reduction of one message per CSR slot over the rows.

    row_ptr: int32 [n+1]; x: f32, i32 or int8 with at least row_ptr[-1]
    entries (or needs an integer type); plan: as for pull_reduce."""
    if op not in _OPS:
        raise ValueError(f"unknown segment_reduce op {op!r}")
    if not x.is_cuda:
        if x.device.type == "cpu":
            return segment_reduce_ref(row_ptr, x, op)
        raise ValueError(f"segment_reduce: no kernel for {x.device}")
    launch = _SEGMENT.get(x.dtype)
    if launch is None or x.dim() != 1 or not x.is_contiguous():
        raise TypeError(f"segment_reduce: x must be a contiguous 1-D f32, i32 "
                        f"or int8 tensor, got {x.dtype} of shape "
                        f"{tuple(x.shape)}")
    if op == "or" and x.dtype.is_floating_point:
        raise TypeError("segment_reduce: or needs an integer type")
    dev = x.get_device()
    if row_ptr.dtype != torch.int32 or row_ptr.dim() != 1 \
            or row_ptr.get_device() != dev or not row_ptr.is_contiguous():
        raise ValueError(f"segment_reduce: row_ptr must be a contiguous 1-D "
                         f"int32 tensor on {x.device}")
    plan, carry = _launch_plan("segment_reduce", row_ptr, plan)
    ident = M.get(op).identity(x.dtype).item()
    out = torch.empty(row_ptr.shape[0] - 1, dtype=x.dtype, device=x.device)
    launch(dev, row_ptr.data_ptr(), x.data_ptr(), out.data_ptr(),
           plan.tiles.data_ptr(), plan.n_tiles, plan.fix.data_ptr(),
           plan.n_fix, None if carry is None else carry.data_ptr(), _OPS[op],
           ident)
    segment_reduce.launches += 1
    return out


segment_reduce.launches = 0
