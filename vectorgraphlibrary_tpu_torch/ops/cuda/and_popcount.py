"""The AND-popcount kernel: wrapper, plain PyTorch version and launch count.

`and_popcount(bits, u, v, chunk)` computes, for every chunk c of `chunk`
consecutive entries of the edge lists u and v (the last chunk may be short),

    out[c] = sum over i in chunk c, w < words of popcount(bits[u[i], w] & bits[v[i], w])

as int32 [ceil(n / chunk)]. It is the hot loop of the triangle count
(models/tc._tc_block_count): bits is one column block of the degree-oriented
adjacency as an int32 [rows, words] bitmap, and an edge (u, v) adds the
common out-neighbours of u and v inside the block. The JAX package computes
it outside Pallas (vectorgraphlibrary_tpu/models/tc.py::_tc_block_count);
csrc/and_popcount.cu says why the port has a kernel for it and what bounds
it on the card.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the hand-written kernel (built by nvcc for sm_90a at first use) or
raises. There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_M1, _M2, _M4 = 0x55555555, 0x33333333, 0x0F0F0F0F


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """The count of set bits of each int32 of x, as int32 (torch has no
    popcount): SWAR with masks and shifts. Bit 31 is counted apart, so every
    step works on non-negative values and no int32 sum overflows."""
    top = (x < 0).to(torch.int32)
    x = x & 0x7FFFFFFF
    x = (x & _M1) + ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    x = x + (x >> 8)
    x = x + (x >> 16)
    return (x & 0x3F) + top


def _check_chunk(chunk: int) -> None:
    if chunk <= 0:
        raise ValueError(f"and_popcount: chunk must be positive, got {chunk}")


def and_popcount_ref(bits: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                     chunk: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arguments, same result): per
    chunk, one gather of each side's rows, their AND, popcount32 and a sum,
    in slices of at most 2^24 words so that no temporary exceeds 64 MiB."""
    _check_chunk(chunk)
    n = u.shape[0]
    step = min(chunk, max(1, (1 << 24) // max(bits.shape[1], 1)))
    sums = []
    for c0 in range(0, n, chunk):
        acc = torch.zeros((), dtype=torch.int32, device=bits.device)
        for s0 in range(c0, min(c0 + chunk, n), step):
            s1 = min(s0 + step, c0 + chunk)
            ru = bits[u[s0:s1].long()]
            rv = bits[v[s0:s1].long()]
            acc += popcount32(ru & rv).sum(dtype=torch.int32)
        sums.append(acc)
    if not sums:
        return torch.zeros(0, dtype=torch.int32, device=bits.device)
    return torch.stack(sums)


def and_popcount(bits: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                 chunk: int) -> torch.Tensor:
    """Per-chunk sums of popcount(bits[u] & bits[v]) (module doc).

    bits: int32 [rows, words]; u, v: int32 [n] with every entry in
    [0, rows), which the kernel does not check. A chunk's sum must stay below
    2^31, as the caller knows from its rows (models/tc.vgl_triangle_count
    checks it). An empty edge list gives an empty result and launches
    nothing."""
    if bits.dtype != torch.int32 or bits.dim() != 2:
        raise TypeError(f"and_popcount: bits must be a 2-D int32 tensor, got "
                        f"{bits.dtype} of shape {tuple(bits.shape)}")
    for name, t in (("u", u), ("v", v)):
        if t.dtype != torch.int32 or t.dim() != 1 or t.shape != u.shape:
            raise TypeError(f"and_popcount: {name} must be a 1-D int32 "
                            f"tensor shaped like u")
    _check_chunk(chunk)
    if bits.device.type == "cpu":
        return and_popcount_ref(bits, u, v, chunk)
    if bits.device.type != "cuda":
        raise ValueError(f"and_popcount: no kernel for {bits.device}")
    for name, t in (("bits", bits), ("u", u), ("v", v)):
        if t.device != bits.device or not t.is_contiguous():
            raise ValueError(f"and_popcount: {name} must be contiguous on "
                             f"{bits.device}")
    n = u.shape[0]
    n_chunks = -(-n // chunk)
    out = torch.empty(n_chunks, dtype=torch.int32, device=bits.device)
    if n_chunks == 0:
        return out
    fn = build.entry("vgl_and_popcount", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    stream = torch.cuda.current_stream(bits.device).cuda_stream
    with build.on_device(bits.device):
        rc = fn(bits.data_ptr(), bits.shape[1], u.data_ptr(), v.data_ptr(), n,
                chunk, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"and_popcount kernel launch failed: CUDA error "
                           f"{rc}")
    and_popcount.launches += 1
    return out


and_popcount.launches = 0
