"""The expand-and-scatter kernel: wrapper, plain PyTorch version and launch
count.

`push_expand(out, row_ptr, col_idx, degrees, ids, valid, edge_capacity, msg,
op)` returns a copy of the int32 array `out` in which, for every valid
frontier entry j (degree degs[j] = degrees[ids[j]], inclusive prefix sum
ends, starts = ends - degs) and every k < degs[j] with starts[j] + k <
edge_capacity,

    out'[col_idx[row_ptr[ids[j]] + k]] op= msg          op in {min, max, or}

Edges past the capacity drop; invalid and zero-degree entries own no edge.
It is ops/advance.advance_push_sparse for an edge op whose message is one
int32 constant (the BFS top-down step) in one launch; csrc/push_expand.cu
says what bounds it on the card.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the hand-written kernel (built by nvcc for sm_90a at first use) or
raises. There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .scatter_combine import scatter_combine_ref

_OPS = {"min": 0, "max": 1, "or": 2}
_P, _LL = ctypes.c_void_p, ctypes.c_longlong
# out, n_out, row_ptr, rows, col_idx, ids, ends, cap, edge capacity, msg, op
_LAUNCH = build.Launcher("vgl_push_expand_i32", _P, _LL, _P, _LL, _P, _P, _P,
                         _LL, _LL, ctypes.c_int, ctypes.c_int)


def _frontier_degrees(degrees: torch.Tensor, ids: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """degrees[ids] (ids clipped into range, as jnp.take(mode="clip")),
    0 where the entry is not valid."""
    idx = ids.clamp(0, degrees.shape[0] - 1)
    return torch.where(valid, degrees.index_select(0, idx), 0)


def push_expand_ref(out: torch.Tensor, row_ptr: torch.Tensor,
                    col_idx: torch.Tensor, degrees: torch.Tensor,
                    ids: torch.Tensor, valid: torch.Tensor, edge_capacity: int,
                    msg: int, op: str) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arguments, same result):
    the frontier's edges listed by repeat_interleave, cut at the capacity,
    then one scatter-combine."""
    degs = _frontier_degrees(degrees, ids, valid).long()
    starts = torch.cumsum(degs, 0) - degs
    owner = torch.repeat_interleave(
        torch.arange(ids.shape[0], device=out.device), degs)[:edge_capacity]
    k = torch.arange(owner.shape[0], device=out.device) - starts[owner]
    rows = row_ptr[ids.long().clamp(0, row_ptr.shape[0] - 1)][owner].long()
    dsts = col_idx[rows + k]
    return scatter_combine_ref(out, dsts, msg, op)


def push_expand(out: torch.Tensor, row_ptr: torch.Tensor,
                col_idx: torch.Tensor, degrees: torch.Tensor,
                ids: torch.Tensor, valid: torch.Tensor, edge_capacity: int,
                msg: int, op: str) -> torch.Tensor:
    """New int32 tensor: `out` with msg combined into every edge target of
    the frontier (module doc). out: int32 [n_out]; row_ptr: int32 [n + 1];
    col_idx, degrees: int32; ids: int32 [cap] (pad = n); valid: bool [cap];
    msg: an int32 constant."""
    if op not in _OPS:
        raise ValueError(f"unknown push_expand op {op!r}")
    msg = int(msg)
    if not -2**31 <= msg < 2**31:
        raise ValueError(f"push_expand: message {msg} is not int32")
    if not out.is_cuda:
        if out.device.type == "cpu":
            return push_expand_ref(out, row_ptr, col_idx, degrees, ids, valid,
                                   edge_capacity, msg, op)
        raise ValueError(f"push_expand: no kernel for {out.device}")
    if out.dtype != torch.int32 or out.dim() != 1 or out.shape[0] >= 2**31:
        raise TypeError(f"push_expand: out must be a 1-D int32 tensor, got "
                        f"{out.dtype} of shape {tuple(out.shape)}")
    dev = out.get_device()
    for name, t, dtype in (("row_ptr", row_ptr, torch.int32),
                           ("col_idx", col_idx, torch.int32),
                           ("degrees", degrees, torch.int32),
                           ("ids", ids, torch.int32),
                           ("valid", valid, torch.bool)):
        if t.dtype != dtype or t.dim() != 1 or t.get_device() != dev \
                or not t.is_contiguous():
            raise ValueError(f"push_expand: {name} must be a contiguous 1-D "
                             f"{dtype} tensor on {out.device}")
    if valid.shape != ids.shape:
        raise ValueError("push_expand: valid and ids differ in shape")
    res = out.clone()
    cap = ids.shape[0]
    if cap == 0 or edge_capacity <= 0:
        return res
    ends = torch.cumsum(_frontier_degrees(degrees, ids, valid), 0,
                        dtype=torch.int32)
    _LAUNCH(dev, res.data_ptr(), res.shape[0], row_ptr.data_ptr(),
            row_ptr.shape[0] - 1, col_idx.data_ptr(), ids.data_ptr(),
            ends.data_ptr(), cap, int(edge_capacity), msg, _OPS[op])
    push_expand.launches += 1
    return res


push_expand.launches = 0
