"""The lane-shuffle kernel: wrapper, plain PyTorch version and launch count.

`lane_shuffle(x2d, idx2d)` computes, over rows of 128 lanes,

    out[r, l] = x2d[r, idx2d[r, l]]

It replaces the TPU kernel vectorgraphlibrary_tpu/ops/route.py::
_lane_shuffle_tpu, the middle of a Beneš route executed stage by stage (the
port runs it when it loads a persisted graph, ops/route.apply_route_stages);
the source note in csrc/lane_shuffle.cu says what bounds it on the card.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the hand-written kernel (built by nvcc for sm_90a at first use) or
raises. There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_ELEM_BYTES = {torch.float32: 4, torch.int32: 4, torch.int8: 1}
# 1-byte types the kernel moves as int8 bits
_AS_INT8 = (torch.uint8, torch.bool)


def lane_shuffle_ref(x2d: torch.Tensor, idx2d: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arguments, same result)."""
    return torch.gather(x2d, 1, idx2d.long())


def lane_shuffle(x2d: torch.Tensor, idx2d: torch.Tensor) -> torch.Tensor:
    """out[r, l] = x2d[r, idx2d[r, l]] (module doc).

    x2d: f32, i32, int8, uint8 or bool [rows, 128]; idx2d: int32 [rows, 128]
    with values in [0, 128), which the kernel does not check (it reads them
    modulo 128; a route's lane indices come from the router or a file whose
    routes the loader checks)."""
    if x2d.dim() != 2 or x2d.shape[1] != 128:
        raise ValueError(f"lane_shuffle: x must be [rows, 128], got "
                         f"{tuple(x2d.shape)}")
    if idx2d.dtype != torch.int32 or idx2d.shape != x2d.shape:
        raise TypeError(f"lane_shuffle: idx must be int32 of shape "
                        f"{tuple(x2d.shape)}, got {idx2d.dtype} of shape "
                        f"{tuple(idx2d.shape)}")
    if x2d.dtype not in _ELEM_BYTES and x2d.dtype not in _AS_INT8:
        raise TypeError(f"lane_shuffle: unsupported dtype {x2d.dtype}")
    if x2d.device.type == "cpu":
        return lane_shuffle_ref(x2d, idx2d)
    if x2d.device.type != "cuda":
        raise ValueError(f"lane_shuffle: no kernel for {x2d.device}")
    if x2d.dtype in _AS_INT8:
        return lane_shuffle(x2d.view(torch.int8), idx2d).view(x2d.dtype)
    for name, t in (("x", x2d), ("idx", idx2d)):
        if t.device != x2d.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"lane_shuffle: {name} must be contiguous and "
                             f"16-byte aligned on {x2d.device}")
    fn = build.entry("vgl_lane_shuffle", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p])
    out = torch.empty_like(x2d)
    stream = torch.cuda.current_stream(x2d.device).cuda_stream
    with build.on_device(x2d.device):
        rc = fn(x2d.data_ptr(), idx2d.data_ptr(), out.data_ptr(),
                x2d.shape[0], _ELEM_BYTES[x2d.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"lane_shuffle kernel launch failed: CUDA error {rc}")
    lane_shuffle.launches += 1
    return out


lane_shuffle.launches = 0
