"""The scatter-combine kernel: wrapper, plain PyTorch version and launch count.

`scatter_combine(out, idx, msg, op)` returns a new tensor equal to `out`
(int32 or f32), with every message msg[i] combined into out[idx[i]] by op in
{"min", "max", "or", "add"} (f32: min and max; the int32 add wraps modulo
2^32 as torch's does); a message whose index lies outside
[0, len(out)) is dropped. `msg` is a tensor of out's dtype shaped like `idx`,
or one number for every message. The f32 min is the combine of SSSP's sparse
push; csrc/scatter_combine.cu says how it orders -0.0 and NaN (distances
hold neither). It replaces the TPU kernel of apps/exp_push.py (make_c/_kern, the
case op="or", msg=1) and runs the scatter stages of the generic sparse push
(ops/advance.advance_push_sparse, through Monoid.scatter_at) and the int32
add of Monoid.scatter_at("add") (the triangle count's bitmaps); the BFS push
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

_OPS = {"min": 0, "max": 1, "or": 2, "add": 3}
_P, _LL = ctypes.c_void_p, ctypes.c_longlong
# out, n_out, idx, msg, msg constant, n, op
_LAUNCH = {dtype: build.Launcher(name, _P, _LL, _P, _P, msg_t, _LL,
                                 ctypes.c_int)
           for dtype, name, msg_t in (
               (torch.int32, "vgl_scatter_combine_i32", ctypes.c_int),
               (torch.float32, "vgl_scatter_combine_f32", ctypes.c_float))}
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


def _messages(idx: torch.Tensor, msg, dtype) -> torch.Tensor:
    if isinstance(msg, torch.Tensor):
        return msg
    return torch.full(idx.shape, msg, dtype=dtype, device=idx.device)


def scatter_combine_ref(out: torch.Tensor, idx: torch.Tensor,
                        msg: Union[torch.Tensor, int], op: str) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arguments, same result).
    min/max/add: one scatter_reduce with a dump slot; or: bit by bit, as the
    amax of each bit, so words with bit 31 set stay exact."""
    if op not in _OPS:
        raise ValueError(f"unknown scatter_combine op {op!r}")
    msg = _messages(idx, msg, out.dtype)
    if op != "or":
        return scatter_reduce_drop(out, idx, msg, op)
    res = out.clone()
    for b in range(32):
        bit = (msg >> b) & 1
        res |= scatter_reduce_drop(torch.zeros_like(out), idx, bit, "max") << b
    return res


def scatter_combine(out: torch.Tensor, idx: torch.Tensor,
                    msg: Union[torch.Tensor, int], op: str) -> torch.Tensor:
    """New tensor: `out` with msg combined in at idx by op (module doc).

    out: int32 or f32 [n_out], n_out < 2^31; idx: int32 [n]; msg: out's dtype
    [n] or one number; f32 takes min and max only (an f32 add by atomics
    would round in a different order on every run). The result is a copy:
    `out` is not changed."""
    if op not in _OPS:
        raise ValueError(f"unknown scatter_combine op {op!r}")
    if not out.is_cuda:
        if out.device.type == "cpu":
            return scatter_combine_ref(out, idx, msg, op)
        raise ValueError(f"scatter_combine: no kernel for {out.device}")
    launch = _LAUNCH.get(out.dtype)
    if launch is None or out.dim() != 1:
        raise TypeError(f"scatter_combine: out must be a 1-D int32 or f32 "
                        f"tensor, got {out.dtype} of shape {tuple(out.shape)}")
    is_f32 = out.dtype == torch.float32
    if is_f32 and op in ("or", "add"):
        raise TypeError(f"scatter_combine: {op} needs int32")
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise TypeError("scatter_combine: idx must be a 1-D int32 tensor")
    dev = out.get_device()
    if idx.get_device() != dev or not idx.is_contiguous():
        raise ValueError(f"scatter_combine: idx must be contiguous on "
                         f"{out.device}, got {idx.device}")
    if out.shape[0] >= 2**31:
        raise ValueError("scatter_combine: out exceeds int32 indices")
    msg_const = 0
    if isinstance(msg, torch.Tensor):
        if msg.dtype != out.dtype or msg.shape != idx.shape \
                or msg.get_device() != dev or not msg.is_contiguous():
            raise ValueError(f"scatter_combine: msg must be a contiguous "
                             f"{out.dtype} tensor of shape "
                             f"{tuple(idx.shape)} on {out.device}")
        msg_ptr = msg.data_ptr()
    else:
        msg_const = float(msg) if is_f32 else int(msg)
        if not is_f32 and not -2**31 <= msg_const < 2**31:
            raise ValueError(f"scatter_combine: message {msg} is not int32")
        msg_ptr = None
    res = out.contiguous().clone()
    launch(dev, res.data_ptr(), res.shape[0], idx.data_ptr(), msg_ptr,
           msg_const, idx.shape[0], _OPS[op])
    scatter_combine.launches += 1
    return res


scatter_combine.launches = 0
