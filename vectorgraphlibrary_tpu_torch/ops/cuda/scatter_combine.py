"""The scatter-combine kernel: wrapper, plain PyTorch version and launch count.

`scatter_combine(out, idx, msg, op)` returns a new int32 tensor equal to
`out`, with every message msg[i] combined into out[idx[i]] by op in
{"min", "max", "or"}; a message whose index lies outside [0, len(out)) is
dropped. `msg` is an int32 tensor shaped like `idx`, or one int for every
message. It replaces the TPU kernel of apps/exp_push.py (make_c/_kern, the
case op="or", msg=1) and runs the scatter stages of the generic sparse push
(ops/advance.advance_push_sparse, through Monoid.scatter_at); the BFS push
runs csrc/push_expand.cu instead. csrc/scatter_combine.cu says what bounds
it on the card.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the hand-written kernel (built by nvcc for sm_90a at first use) or
raises. There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
from typing import Union

import torch

from . import build

_OPS = {"min": 0, "max": 1, "or": 2}
_fn = None          # the library's entry, looked up at the first launch
_REDUCE = {"add": "sum", "min": "amin", "max": "amax"}


def scatter_reduce_drop(target: torch.Tensor, idx: torch.Tensor,
                        vals: torch.Tensor, op: str) -> torch.Tensor:
    """New tensor: target with vals combined in at idx by op in (add, min,
    max), any dtype; indices outside [0, len(target)) are dropped. They go to
    one dump slot past the end, which is cut off after, so no boolean mask
    has to be read back to the host."""
    n = target.shape[0]
    vals = vals.to(target.dtype)
    is_bool = target.dtype == torch.bool
    if is_bool:       # scatter_reduce takes no bool; {0,1} as int32
        target, vals = target.to(torch.int32), vals.to(torch.int32)
    ext = torch.cat([target, target.new_zeros(1)])
    idx = idx.long()
    idx = torch.where((idx >= 0) & (idx < n), idx, n)
    ext.scatter_reduce_(0, idx, vals, _REDUCE[op], include_self=True)
    out = ext[:n]
    return out.to(torch.bool) if is_bool else out


def _messages(idx: torch.Tensor, msg) -> torch.Tensor:
    if isinstance(msg, torch.Tensor):
        return msg
    return torch.full(idx.shape, int(msg), dtype=torch.int32, device=idx.device)


def scatter_combine_ref(out: torch.Tensor, idx: torch.Tensor,
                        msg: Union[torch.Tensor, int], op: str) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arguments, same result).
    min/max: one scatter_reduce with a dump slot; or: bit by bit, as the
    amax of each bit, so words with bit 31 set stay exact."""
    if op not in _OPS:
        raise ValueError(f"unknown scatter_combine op {op!r}")
    msg = _messages(idx, msg)
    if op != "or":
        return scatter_reduce_drop(out, idx, msg, op)
    res = out.clone()
    for b in range(32):
        bit = (msg >> b) & 1
        res |= scatter_reduce_drop(torch.zeros_like(out), idx, bit, "max") << b
    return res


def scatter_combine(out: torch.Tensor, idx: torch.Tensor,
                    msg: Union[torch.Tensor, int], op: str) -> torch.Tensor:
    """New int32 tensor: `out` with msg combined in at idx by op (module doc).

    out: int32 [n_out], n_out < 2^31; idx: int32 [n]; msg: int32 [n] or an
    int. The result is a copy: `out` is not changed."""
    if op not in _OPS:
        raise ValueError(f"unknown scatter_combine op {op!r}")
    if out.device.type == "cpu":
        return scatter_combine_ref(out, idx, msg, op)
    if out.device.type != "cuda":
        raise ValueError(f"scatter_combine: no kernel for {out.device}")
    if out.dtype != torch.int32 or out.dim() != 1:
        raise TypeError(f"scatter_combine: out must be a 1-D int32 tensor, "
                        f"got {out.dtype} of shape {tuple(out.shape)}")
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise TypeError("scatter_combine: idx must be a 1-D int32 tensor")
    if idx.device != out.device or not idx.is_contiguous():
        raise ValueError(f"scatter_combine: idx must be contiguous on "
                         f"{out.device}, got {idx.device}")
    if out.shape[0] >= 2**31:
        raise ValueError("scatter_combine: out exceeds int32 indices")
    msg_const = 0
    if isinstance(msg, torch.Tensor):
        if msg.dtype != torch.int32 or msg.shape != idx.shape \
                or msg.device != out.device or not msg.is_contiguous():
            raise ValueError(f"scatter_combine: msg must be a contiguous "
                             f"int32 tensor of shape {tuple(idx.shape)} on "
                             f"{out.device}")
        msg_ptr = msg.data_ptr()
    else:
        msg_const = int(msg)
        if not -2**31 <= msg_const < 2**31:
            raise ValueError(f"scatter_combine: message {msg} is not int32")
        msg_ptr = None
    global _fn
    if _fn is None:
        _fn = build.entry("vgl_scatter_combine_i32", [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p])
    res = out.contiguous().clone()
    stream = torch.cuda.current_stream(out.device).cuda_stream
    with build.on_device(out.device):
        rc = _fn(res.data_ptr(), res.shape[0], idx.data_ptr(), msg_ptr,
                 msg_const, idx.shape[0], _OPS[op], stream)
    if rc != 0:
        raise RuntimeError(f"scatter_combine kernel launch failed: CUDA "
                           f"error {rc}")
    scatter_combine.launches += 1
    return res


scatter_combine.launches = 0
