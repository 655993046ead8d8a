"""The route-gather kernel: wrapper, plain PyTorch version and launch count.

`route_gather_finish` computes, for every output slot i,

    out[i] = keep(i) ? wop(x[idx[i]], weights[i]) : ident

with keep(i) = (flags[i] & 1) and not (exclude_self_loops and flags[i] & 2)
when flags are given, else true. It replaces the reference's route kernels
(vectorgraphlibrary_tpu/ops/pallas/route_fused.py: _big_kernel, _mid_kernel
and the _finish epilogue); the source note in csrc/route_gather.cu says what
bounds it on the card.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the hand-written kernel (built by nvcc for sm_90a at first use) or
raises. There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build, f32_order

_WOPS = {None: 0, "add": 1, "min": 2, "max": 3, "mul": 4}
_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# x, idx, flags, weights, out, n, exclude_self_loops, weight op, ident
_FINISH = {dtype: (build.Launcher(name, _P, _P, _P, _P, _P, _LL, _I, _I,
                                  ident_t), cast)
           for dtype, name, ident_t, cast in (
               (torch.float32, "vgl_route_gather_f32", ctypes.c_float, float),
               (torch.int32, "vgl_route_gather_i32", _I, int),
               (torch.int8, "vgl_route_gather_i8", _I, int))}
# without flags and weights (the vertex routes) the kernel moves bits,
# through an entry of 4 arguments: x, idx, out, n (ctypes converts each
# argument on every launch)
_B4 = build.Launcher("vgl_route_gather_b4", _P, _P, _P, _LL)
_PLAIN = {torch.float32: _B4, torch.int32: _B4,
          torch.int8: build.Launcher("vgl_route_gather_b1", _P, _P, _P, _LL)}


def route_gather_finish_ref(x: torch.Tensor, idx: torch.Tensor,
                            flags: Optional[torch.Tensor] = None,
                            weights: Optional[torch.Tensor] = None,
                            weight_op: Optional[str] = None,
                            exclude_self_loops: bool = False,
                            ident=0) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arguments, same result)."""
    y = x[idx.long()]
    if weight_op is not None:
        op = {"add": torch.add, "min": f32_order.minimum,
              "max": f32_order.maximum, "mul": torch.mul}[weight_op]
        y = op(y, weights)
    if flags is not None:
        keep = (flags & 1) != 0
        if exclude_self_loops:
            keep &= (flags & 2) == 0
        y = torch.where(keep, y, torch.tensor(ident, dtype=y.dtype,
                                              device=y.device))
    return y


def route_gather_finish(x: torch.Tensor, idx: torch.Tensor,
                        flags: Optional[torch.Tensor] = None,
                        weights: Optional[torch.Tensor] = None,
                        weight_op: Optional[str] = None,
                        exclude_self_loops: bool = False,
                        ident=0) -> torch.Tensor:
    """out[i] = keep(i) ? wop(x[idx[i]], weights[i]) : ident (module doc).

    x: f32, i32 or int8 [m]; idx: int32 [n] with values in [0, m), which
    the kernel does not check (make_route_plan checks its plans on the
    host); flags: uint8 [n] or None; weights: x's dtype [n] iff weight_op."""
    if weight_op not in _WOPS:
        raise ValueError(f"unknown weight_op {weight_op!r}")
    if (weights is None) != (weight_op is None):
        raise ValueError("weights must be given exactly when weight_op is")
    if not x.is_cuda:
        if x.device.type == "cpu":
            return route_gather_finish_ref(x, idx, flags, weights, weight_op,
                                           exclude_self_loops, ident)
        raise ValueError(f"route_gather_finish: no kernel for {x.device}")
    finish = _FINISH.get(x.dtype)
    if finish is None:
        raise TypeError(f"route_gather_finish: unsupported dtype {x.dtype}")
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise TypeError("idx must be a 1-D int32 tensor")
    if x.dim() != 1:
        raise ValueError("x must be 1-D")
    dev = x.get_device()
    n = idx.shape[0]
    if idx.get_device() != dev or not (x.is_contiguous()
                                       and idx.is_contiguous()):
        raise ValueError(f"x and idx must be contiguous on {x.device}")
    out = x.new_empty(n)
    if flags is None and weights is None:
        _PLAIN[x.dtype](dev, x.data_ptr(), idx.data_ptr(), out.data_ptr(), n)
    else:
        for name, t, dtype in (("flags", flags, torch.uint8),
                               ("weights", weights, x.dtype)):
            if t is not None and (t.get_device() != dev or t.dtype != dtype
                                  or t.shape != (n,)
                                  or not t.is_contiguous()):
                raise ValueError(f"{name}: need a contiguous {dtype} tensor "
                                 f"of shape ({n},) on {x.device}, got "
                                 f"{t.dtype} of shape {tuple(t.shape)} on "
                                 f"{t.device}")
        launch, cast = finish
        launch(dev, x.data_ptr(), idx.data_ptr(),
               None if flags is None else flags.data_ptr(),
               None if weights is None else weights.data_ptr(),
               out.data_ptr(), n, exclude_self_loops, _WOPS[weight_op],
               cast(ident))
    route_gather_finish.launches += 1
    return out


route_gather_finish.launches = 0
