"""The feature-row pull kernel: wrapper, plain PyTorch version and launch
count.

`pull_rows(csr, x)` computes, for every row v of `csr` (a RowCSR),

    out[v, :] = sum over k in [row_ptr[v], row_ptr[v+1]) of x[col_idx[k], :]

for f32 x [n_x, F] of any F, as f32 [n_rows, F] (zeros for an empty row).
It is GraphSAGE's aggregation (models/gnn.aggregate_sum_count) over the
direction's CSR and, over the transposed CSR, its gradient. The JAX package
computes it outside Pallas (vectorgraphlibrary_tpu/models/gnn.py:29-80);
csrc/pull_rows.cu says why the port has a kernel for it and what bounds it on
the card.

A RowCSR holds row_ptr, col_idx and the list of the rows of more than
HUB_MIN edges, which the kernel gives a block each and its warps skip. It
makes that list itself from its own row_ptr (with one read of its length to
the host), so the list always matches the CSR; a caller that pulls over one
CSR many times keeps the RowCSR.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the hand-written kernel (built by nvcc for sm_90a at first use) or
raises. There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

HUB_MIN = 1024      # rows of more edges take a block each (csrc/pull_rows.cu)
# the plain version gathers at most this many values at a time
_REF_ELEMS = 1 << 26
_P, _I = ctypes.c_void_p, ctypes.c_int
# row_ptr, col_idx, x, out, n_rows, F, hub_rows, n_hub, hub_min, vec
_LAUNCH = build.Launcher("vgl_pull_rows_f32", _P, _P, _P, _P, _I, _I, _P, _I,
                         _I, _I)


class RowCSR:
    """A CSR for pull_rows: row_ptr (int32 [n_rows+1]), col_idx (int32) and
    hubs, the int32 ids of the rows of more than HUB_MIN edges, ascending,
    made here from row_ptr."""

    __slots__ = ("row_ptr", "col_idx", "hubs")

    def __init__(self, row_ptr: torch.Tensor, col_idx: torch.Tensor):
        self.row_ptr, self.col_idx = row_ptr, col_idx
        degs = row_ptr[1:] - row_ptr[:-1]
        self.hubs = torch.nonzero(degs > HUB_MIN).flatten().to(torch.int32)


def pull_rows_ref(row_ptr: torch.Tensor, col_idx: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same result, sums in another
    order; any float type): per run of rows, one index_select of the edges'
    rows and one sorted-segment sum, in runs of at most _REF_ELEMS gathered
    values (one row at least), so that no [E, F] array is made."""
    n, f = row_ptr.shape[0] - 1, x.shape[1]
    out = x.new_zeros((n, f))
    rp = row_ptr.cpu().long()             # the runs' bounds, on the host
    budget = max(1, _REF_ELEMS // max(f, 1))
    r0 = 0
    while r0 < n:
        e0 = int(rp[r0])
        r1 = int(torch.searchsorted(rp, e0 + budget, right=True)) - 1
        r1 = min(max(r1, r0 + 1), n)
        e1 = int(rp[r1])
        lengths = (rp[r0 + 1:r1 + 1] - rp[r0:r1]).to(x.device)
        vals = x.index_select(0, col_idx[e0:e1].long())
        out[r0:r1] = torch.segment_reduce(vals, "sum", lengths=lengths,
                                          axis=0, unsafe=True, initial=0.0)
        r0 = r1
    return out


def pull_rows(csr: RowCSR, x: torch.Tensor) -> torch.Tensor:
    """out[v, :] = the sum of x's rows over row v's columns (module doc).

    csr: a RowCSR with every column of a row in [0, len(x)), which the
    kernel does not check; x: f32 [n_x, F]."""
    row_ptr, col_idx, hubs = csr.row_ptr, csr.col_idx, csr.hubs
    if x.dim() != 2:
        raise TypeError(f"pull_rows: x must be 2-D, got shape "
                        f"{tuple(x.shape)}")
    if not x.is_cuda:
        if x.device.type == "cpu":
            return pull_rows_ref(row_ptr, col_idx, x)
        raise ValueError(f"pull_rows: no kernel for {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise TypeError(f"pull_rows: x must be a contiguous f32 tensor, got "
                        f"{x.dtype}")
    dev = x.get_device()
    for name, t in (("row_ptr", row_ptr), ("col_idx", col_idx),
                    ("hubs", hubs)):
        if t.dtype != torch.int32 or t.dim() != 1 or t.get_device() != dev \
                or not t.is_contiguous():
            raise ValueError(f"pull_rows: {name} must be a contiguous 1-D "
                             f"int32 tensor on {x.device}")
    n, f = row_ptr.shape[0] - 1, x.shape[1]
    out = torch.empty((n, f), dtype=torch.float32, device=x.device)
    if n == 0 or f == 0:
        return out.zero_()
    vec = 4 if f % 4 == 0 and x.data_ptr() % 16 == 0 else 1
    _LAUNCH(dev, row_ptr.data_ptr(), col_idx.data_ptr(), x.data_ptr(),
            out.data_ptr(), n, f, hubs.data_ptr() if hubs.numel() else None,
            hubs.numel(), HUB_MIN, vec)
    pull_rows.launches += 1
    return out


pull_rows.launches = 0
