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
(ops/advance.advance_pull_value) in one launch, in place of the route chain
that ran the reference's route kernels (vectorgraphlibrary_tpu/ops/pallas/
route_fused.py: _mid_kernel, _big_kernel, _finish); csrc/pull_reduce.cu says
what bounds it on the card.

`groups` gives the kernel its work units: ascending (row_end, threads per
row) pairs that cover the rows in order, with threads per row in GROUPS
(BLOCK: one block per row). It changes how the rows are spread over the card,
never the result; ops/advance.row_groups makes it from a graph's degree
classes.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the hand-written kernel (built by nvcc for sm_90a at first use) or
raises. There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from .. import monoid as M
from . import build

BLOCK = 512                 # csrc/pull_reduce.cu kThreads
UNROLL = 8                  # csrc/pull_reduce.cu kUnroll: loads per thread
GROUPS = (1, 2, 4, 8, 16, 32, BLOCK)
MAX_GROUPS = 8
_OPS = {"add": 0, "min": 1, "max": 2, "or": 3, "any01": 2}
_WOPS = {None: 0, "add": 1, "min": 2, "max": 3, "mul": 4}
_JOIN = {"add": torch.add, "min": torch.minimum, "max": torch.maximum,
         "mul": torch.mul}
_ENTRY = {torch.float32: ("vgl_pull_reduce_f32", ctypes.c_float),
          torch.int32: ("vgl_pull_reduce_i32", ctypes.c_int),
          torch.int8: ("vgl_pull_reduce_i8", ctypes.c_int)}


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
    """Plain PyTorch version of the kernel (same arguments but the work
    units, same result; f32 sums in another order): one gather of the edges'
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
    return mon.segment_reduce(vals, degs)


def _check_groups(groups: Sequence[Tuple[int, int]], n: int) -> None:
    if not 1 <= len(groups) <= MAX_GROUPS:
        raise ValueError(f"pull_reduce: 1 to {MAX_GROUPS} groups, got "
                         f"{len(groups)}")
    prev = 0
    for row_end, g in groups:
        if g not in GROUPS or row_end < prev:
            raise ValueError(f"pull_reduce: bad groups {groups}")
        prev = row_end
    if prev != n:
        raise ValueError(f"pull_reduce: groups cover {prev} of {n} rows")


def pull_reduce(row_ptr: torch.Tensor, col_idx: torch.Tensor, x: torch.Tensor,
                op: str, exclude_self_loops: bool = False,
                groups: Optional[Sequence[Tuple[int, int]]] = None,
                weights: Optional[torch.Tensor] = None,
                weight_op: Optional[str] = None) -> torch.Tensor:
    """out[v] = op of the messages over row v's columns (module doc).

    row_ptr: int32 [n+1]; col_idx: int32 with every column in [0, len(x)),
    which the kernel does not check; x: f32, i32 or int8 (or needs an
    integer type); groups: as in the module doc, default one warp per row;
    weights: x's dtype (f32 or i32), as long as col_idx, iff weight_op."""
    if op not in _OPS:
        raise ValueError(f"unknown pull_reduce op {op!r}")
    _check_weights(weights, weight_op)
    if x.device.type == "cpu":
        return pull_reduce_ref(row_ptr, col_idx, x, op, exclude_self_loops,
                               weights, weight_op)
    if x.device.type != "cuda":
        raise ValueError(f"pull_reduce: no kernel for {x.device}")
    if x.dtype not in _ENTRY or x.dim() != 1 or not x.is_contiguous():
        raise TypeError(f"pull_reduce: x must be a contiguous 1-D f32, i32 or "
                        f"int8 tensor, got {x.dtype} of shape {tuple(x.shape)}")
    if op == "or" and x.dtype.is_floating_point:
        raise TypeError("pull_reduce: or needs an integer type")
    for name, t in (("row_ptr", row_ptr), ("col_idx", col_idx)):
        if t.dtype != torch.int32 or t.dim() != 1 or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"pull_reduce: {name} must be a contiguous 1-D "
                             f"int32 tensor on {x.device}")
    if weights is not None:
        if x.dtype == torch.int8:
            raise TypeError("pull_reduce: no edge weights with int8 values")
        if weights.dtype != x.dtype or weights.shape != col_idx.shape \
                or weights.device != x.device or not weights.is_contiguous():
            raise ValueError(f"pull_reduce: weights must be a contiguous "
                             f"{x.dtype} tensor of shape "
                             f"{tuple(col_idx.shape)} on {x.device}")
    n = row_ptr.shape[0] - 1
    groups = tuple(groups) if groups is not None else ((n, 32),)
    _check_groups(groups, n)
    fn_name, ident_t = _ENTRY[x.dtype]
    fn = build.entry(fn_name, [ctypes.c_void_p] * 4 + [ctypes.c_int] + [
        ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                ident_t, ctypes.c_void_p])
    ident = M.get(op).identity(x.dtype).item()
    row_end = (ctypes.c_int * len(groups))(*(r for r, _ in groups))
    group = (ctypes.c_int * len(groups))(*(g for _, g in groups))
    out = torch.empty(n, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with build.on_device(x.device):
        rc = fn(row_ptr.data_ptr(), col_idx.data_ptr(), x.data_ptr(),
                None if weights is None else weights.data_ptr(),
                _WOPS[weight_op], out.data_ptr(), row_end, group, len(groups),
                int(bool(exclude_self_loops)), _OPS[op], ident, stream)
    if rc != 0:
        raise RuntimeError(f"pull_reduce kernel launch failed: CUDA error {rc}")
    pull_reduce.launches += 1
    return out


pull_reduce.launches = 0
