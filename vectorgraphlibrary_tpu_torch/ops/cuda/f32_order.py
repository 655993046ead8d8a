"""The port's one f32 min/max rule in plain PyTorch: the plain versions'
side of csrc/f32_minmax.cuh, which route_gather.cu, pull_reduce.cu and
scatter_combine.cu share.

The rule is the JAX package's on the CPU (XLA's minimum and maximum, and the
reductions and scatters built on them; tests/test_torch_f32_order.py holds
the two equal bit for bit): a NaN wins over any number and keeps its bits,
and -0.0 is below +0.0. Of two NaNs, the one whose bits are the smaller as
uint32 wins (XLA leaves that choice unspecified). torch.minimum and
torch.amin on the CPU keep the first of two zeros instead, and
scatter_reduce's amin orders NaN as it meets it.

So a min or max is the least or the greatest element under one total order
of the bit patterns. Each f32 maps to an int64 key in that order (`keys`):
a number to its bits, with a negative number's magnitude bits flipped so
that the integers order as the floats (-0.0 just below +0.0), and a NaN
below every number for min (above for max), offset by its bits. Any
integer min, max, reduction or scatter of the keys is the rule's, and
`values` maps the result back. Other dtypes take torch's own ops.
"""
from __future__ import annotations

import torch

_NAN = 1 << 33              # NaN keys lie beyond +-2^32; numbers within 2^31
_WORD = 1 << 32


def keys(x: torch.Tensor, op: str) -> torch.Tensor:
    """int64 keys of f32 `x` in the rule's order for `op` ("min" or
    "max")."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    num = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)
    ubits = bits & (_WORD - 1)
    nan = ubits - _NAN if op == "min" else _NAN - ubits
    return torch.where(torch.isnan(x), nan, num)


def values(k: torch.Tensor, op: str) -> torch.Tensor:
    """The f32 values of keys `k` (the inverse of `keys`)."""
    if op == "min":
        is_nan, ubits = k < -_WORD, k + _NAN
    else:
        is_nan, ubits = k > _WORD, _NAN - k
    ubits = torch.where(ubits >= 1 << 31, ubits - _WORD, ubits)
    bits = torch.where(is_nan, ubits, torch.where(k >= 0, k, k ^ 0x7FFFFFFF))
    return bits.to(torch.int32).view(torch.float32)


def minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise min by the rule for f32, torch.minimum otherwise."""
    if a.dtype != torch.float32:
        return torch.minimum(a, b)
    b = torch.as_tensor(b, dtype=a.dtype, device=a.device).expand_as(a)
    return values(torch.minimum(keys(a, "min"), keys(b, "min")), "min")


def maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise max by the rule for f32, torch.maximum otherwise."""
    if a.dtype != torch.float32:
        return torch.maximum(a, b)
    b = torch.as_tensor(b, dtype=a.dtype, device=a.device).expand_as(a)
    return values(torch.maximum(keys(a, "max"), keys(b, "max")), "max")


def segment_reduce(data: torch.Tensor, lengths: torch.Tensor, op: str,
                   ident: float) -> torch.Tensor:
    """f32 min or max over consecutive segments of `data` (segment j: the
    next lengths[j] elements); an empty segment gets `ident`."""
    n = lengths.shape[0]
    seg = torch.repeat_interleave(
        torch.arange(n, device=data.device), lengths.long(),
        output_size=data.shape[0])
    out = keys(torch.full((n,), ident, dtype=torch.float32,
                          device=data.device), op)
    out.scatter_reduce_(0, seg, keys(data, op), "a" + op, include_self=True)
    return values(out, op)
