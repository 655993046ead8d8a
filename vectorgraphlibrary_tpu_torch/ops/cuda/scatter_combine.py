"""The scatter-combine kernel: wrapper, plain PyTorch version and launch count.

`scatter_combine(out, idx, msg, op)` returns a new tensor equal to `out`
(int32 or f32), with every message msg[i] combined into out[idx[i]] by op in
{"min", "max", "or", "add"} (f32: min and max; the int32 add wraps modulo
2^32 as torch's does); a message whose index lies outside
[0, len(out)) is dropped. `msg` is a tensor of out's dtype shaped like `idx`,
or one number for every message. `scatter_combine_(out, idx, msg, op)` is the
same combine into `out` itself, for a caller that has just made the target
and does not read it again (the triangle count's bitmaps, the sparse push's
owner mark): the same checks, the same C entries and kernel, no copy. The
f32 min is the combine of SSSP's sparse
push; csrc/scatter_combine.cu says how it orders -0.0 and NaN (distances
hold neither). It replaces the TPU kernel of apps/exp_push.py (make_c/_kern,
the case op="or", msg=1) and runs the scatter stages of the generic sparse push
(ops/advance.advance_push_sparse, through Monoid.scatter_at and
Monoid.scatter_at_) and the int32 add of Monoid.scatter_at_("add") (the
triangle count's bitmaps); the BFS push runs csrc/push_expand.cu instead.
csrc/scatter_combine.cu says what bounds it on the card.

Both entries count their launches on `scatter_combine.launches`: one
kernel, one count.

On a CPU tensor the wrapper runs the plain version (scatter_combine_ref,
scatter_combine_ref_ in place); on a CUDA tensor it launches the
hand-written kernel (built by nvcc for sm_90a at first use) or raises.
There is no fallback from one to the other.
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


def scatter_combine_ref_(out: torch.Tensor, idx: torch.Tensor,
                         msg: Union[torch.Tensor, int],
                         op: str) -> torch.Tensor:
    """Plain version of scatter_combine_: scatter_combine_ref's result
    written into `out`, which is returned."""
    return out.copy_(scatter_combine_ref(out, idx, msg, op))


def _launch(res: torch.Tensor, idx: torch.Tensor,
            msg: Union[torch.Tensor, int], op: str, name: str) -> None:
    """Check a launch into the CUDA tensor `res` and make it (both
    entries' checks, module doc)."""
    launch = _LAUNCH.get(res.dtype)
    if launch is None or res.dim() != 1:
        raise TypeError(f"{name}: out must be a 1-D int32 or f32 "
                        f"tensor, got {res.dtype} of shape {tuple(res.shape)}")
    is_f32 = res.dtype == torch.float32
    if is_f32 and op in ("or", "add"):
        raise TypeError(f"{name}: {op} needs int32")
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise TypeError(f"{name}: idx must be a 1-D int32 tensor")
    dev = res.get_device()
    if idx.get_device() != dev or not idx.is_contiguous():
        raise ValueError(f"{name}: idx must be contiguous on "
                         f"{res.device}, got {idx.device}")
    if res.shape[0] >= 2**31:
        raise ValueError(f"{name}: out exceeds int32 indices")
    msg_const = 0
    if isinstance(msg, torch.Tensor):
        if msg.dtype != res.dtype or msg.shape != idx.shape \
                or msg.get_device() != dev or not msg.is_contiguous():
            raise ValueError(f"{name}: msg must be a contiguous "
                             f"{res.dtype} tensor of shape "
                             f"{tuple(idx.shape)} on {res.device}")
        msg_ptr = msg.data_ptr()
    else:
        msg_const = float(msg) if is_f32 else int(msg)
        if not is_f32 and not -2**31 <= msg_const < 2**31:
            raise ValueError(f"{name}: message {msg} is not int32")
        msg_ptr = None
    launch(dev, res.data_ptr(), res.shape[0], idx.data_ptr(), msg_ptr,
           msg_const, idx.shape[0], _OPS[op])
    scatter_combine.launches += 1


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
    res = out.contiguous().clone()
    _launch(res, idx, msg, op, "scatter_combine")
    return res


def scatter_combine_(out: torch.Tensor, idx: torch.Tensor,
                     msg: Union[torch.Tensor, int],
                     op: str) -> torch.Tensor:
    """scatter_combine into `out` itself, which is returned: the same
    arguments and checks, and `out` must be contiguous. For a target that
    the caller has just made and reads nowhere else. JAX's arrays are
    immutable, and the JAX package's scatter returns a new one; the port
    combines in place here because that saves a copy of the target (537 MB
    for a triangle-count bitmap at RMAT-18) and its device time."""
    if op not in _OPS:
        raise ValueError(f"unknown scatter_combine op {op!r}")
    if not out.is_cuda:
        if out.device.type == "cpu":
            return scatter_combine_ref_(out, idx, msg, op)
        raise ValueError(f"scatter_combine_: no kernel for {out.device}")
    if not out.is_contiguous():
        raise ValueError("scatter_combine_: out must be contiguous")
    _launch(out, idx, msg, op, "scatter_combine_")
    return out


scatter_combine.launches = 0
