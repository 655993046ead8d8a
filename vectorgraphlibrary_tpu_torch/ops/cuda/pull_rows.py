"""The feature-row pull kernel: wrapper, plain PyTorch version and launch
count.

`pull_rows(csr, x)` computes, for every row v of `csr` (a RowCSR),

    out[v, :] = sum over k in [row_ptr[v], row_ptr[v+1]) of x[col_idx[k], :]

for f32 x [n_x, F] of any F, as f32 [n_rows, F] (zeros for an empty row).
It is GraphSAGE's aggregation (models/gnn.aggregate_sum_count) over the
direction's CSR and, over the transposed CSR, its gradient. The JAX package
computes it outside Pallas (vectorgraphlibrary_tpu/models/gnn.py:29-80);
csrc/pull_rows.cu says why the port has a kernel for it, what bounds it on
the card and how it keeps the hottest rows on chip.

A RowCSR holds row_ptr, col_idx, the list of the rows of more than HUB_MIN
edges (`hubs`) and, made at its first launch and kept, the kernel's
schedule for the card's block count (`schedule` below): each hub row whole
to one block, the other rows in contiguous ranges balanced by edges, one
per warp, cut into hub-free parts. Both come from its own row_ptr (one copy
of it to the host), so they always match the CSR; a caller that pulls over
one CSR many times keeps the RowCSR.

The launch takes VEC floats per lane where F and x's alignment allow
(`lanes`) and reads the rows of x below L2_LAST_ROWS with L2's evict_last
policy; both are the best of the values that apps/exp_pull_rows.py --sweep
timed at GraphSAGE's widths on RMAT-20 (csrc/pull_rows.cu has the
numbers). The results' bits do not depend on them.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the hand-written kernel (built by nvcc for sm_90a at first use) or
raises. There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import heapq
from typing import NamedTuple

import numpy as np
import torch

from . import build

HUB_MIN = 1024      # rows of more edges go whole to a block
WARPS = 32          # warps per block (csrc/pull_rows.cu kThreads / 32)
VEC = 4             # floats per lane where F and x's alignment allow
# columns below it read with L2's evict_last policy, the others evict_first
L2_LAST_ROWS = 1 << 16
# the plain version gathers at most this many values at a time
_REF_ELEMS = 1 << 26
_P, _I = ctypes.c_void_p, ctypes.c_int
# row_ptr, col_idx, x, out, n_rows, F, vec, l2_rows, n_blocks, hub_rows,
# blk_hub, warp_part, parts
_LAUNCH = build.Launcher("vgl_pull_rows_f32", _P, _P, _P, _P, _I, _I, _I,
                         _I, _I, _P, _P, _P, _P)


def lanes(f: int, align: int) -> tuple:
    """The kernel's lanes for F = f and x's address and row stride in bytes
    OR-ed together (`align`): (vec, cv, n_chunks), the most floats per lane,
    at most VEC, that F and the alignment allow, and F / vec vectors in
    n_chunks equal chunks of cv <= 32 lanes (csrc/pull_rows.cu works out
    cv and n_chunks the same way)."""
    vec = VEC
    while vec > 1 and (f % vec or align % (4 * vec)):
        vec //= 2
    fv = f // vec
    n_chunks = max(1, -(-fv // 32))
    return vec, -(-fv // n_chunks) if fv else 0, n_chunks


class Schedule(NamedTuple):
    """The kernel's work for n_blocks blocks of WARPS warps (numpy int32):
    hub_rows grouped by block, block p's in hub_rows[blk_hub[p]:
    blk_hub[p+1]]; warp q = p * WARPS + w's hub-free row ranges parts[
    warp_part[q]:warp_part[q+1]], each [r0, r1)."""
    hub_rows: np.ndarray
    blk_hub: np.ndarray
    warp_part: np.ndarray
    parts: np.ndarray


def schedule(row_ptr: np.ndarray, n_blocks: int) -> Schedule:
    """Split a CSR's rows for the kernel (csrc/pull_rows.cu): each row of
    more than HUB_MIN edges whole to a block, largest first onto the least
    loaded; the other rows, weighted by edges + 1, in one contiguous range
    per warp, ranges in row order, each block's hub weight counted against
    its warps' share; each range cut at the hub rows into parts."""
    rp = np.asarray(row_ptr, dtype=np.int64)
    n = rp.shape[0] - 1
    deg = np.diff(rp)
    is_hub = deg > HUB_MIN
    hubs = np.flatnonzero(is_hub)
    load = [(0, p) for p in range(n_blocks)]
    owner = np.empty(hubs.shape[0], np.int64)
    hub_load = np.zeros(n_blocks, np.int64)
    for i in np.argsort(-deg[hubs], kind="stable"):
        w, p = heapq.heappop(load)
        owner[i] = p
        hub_load[p] = w + deg[hubs[i]] + 1
        heapq.heappush(load, (int(hub_load[p]), p))
    by_block = np.argsort(owner, kind="stable")
    blk_hub = np.searchsorted(owner[by_block], np.arange(n_blocks + 1))

    # warp boundaries over the non-hub rows' cumulative weight
    cum = np.concatenate([[0], np.cumsum(np.where(is_hub, 0, deg + 1))])
    total = cum[-1] + hub_load.sum()
    budget = np.maximum(total / n_blocks - hub_load, 0.0)
    blk_at = np.concatenate([[0.0], np.cumsum(budget)])
    if blk_at[-1] > 0:
        blk_at *= cum[-1] / blk_at[-1]
    t = (blk_at[:-1, None] + np.diff(blk_at)[:, None]
         * np.arange(WARPS)[None, :] / WARPS).ravel()
    bounds = np.minimum(np.searchsorted(cum, t, side="left"), n)
    bounds = np.append(np.maximum.accumulate(bounds), n)
    bounds[0] = 0

    # parts: the warp ranges cut at each hub row, hub rows and empty
    # pieces left out
    cuts = np.unique(np.concatenate([bounds, hubs, hubs + 1]))
    lo, hi = cuts[:-1], cuts[1:]
    keep = hi > lo
    keep[keep] = ~is_hub[lo[keep]]
    lo, hi = lo[keep], hi[keep]
    warp_of = np.searchsorted(bounds, lo, side="right") - 1
    warp_part = np.searchsorted(warp_of, np.arange(n_blocks * WARPS + 1))
    i32 = np.int32
    return Schedule(hubs[by_block].astype(i32), blk_hub.astype(i32),
                    warp_part.astype(i32),
                    np.stack([lo, hi], axis=1).astype(i32).reshape(-1, 2))


class RowCSR:
    """A CSR for pull_rows: row_ptr (int32 [n_rows+1]), col_idx (int32),
    hubs (the int32 ids of the rows of more than HUB_MIN edges, ascending)
    and the kernel's schedule per block count, made at first use; all from
    row_ptr."""

    __slots__ = ("row_ptr", "col_idx", "hubs", "_plans")

    def __init__(self, row_ptr: torch.Tensor, col_idx: torch.Tensor):
        self.row_ptr, self.col_idx = row_ptr, col_idx
        degs = row_ptr[1:] - row_ptr[:-1]
        self.hubs = torch.nonzero(degs > HUB_MIN).flatten().to(torch.int32)
        self._plans: dict = {}

    def plan(self, n_blocks: int) -> tuple:
        """The schedule for n_blocks blocks as int32 tensors on row_ptr's
        device (hub_rows, blk_hub, warp_part, parts), kept."""
        got = self._plans.get(n_blocks)
        if got is None:
            s = schedule(self.row_ptr.cpu().numpy(), n_blocks)
            got = tuple(torch.from_numpy(a).to(self.row_ptr.device)
                        for a in s)
            self._plans[n_blocks] = got
        return got


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


_sm_count: dict = {}


def pull_rows(csr: RowCSR, x: torch.Tensor) -> torch.Tensor:
    """out[v, :] = the sum of x's rows over row v's columns (module doc).

    csr: a RowCSR with every column of a row in [0, len(x)), which the
    kernel does not check; x: f32 [n_x, F]."""
    row_ptr, col_idx = csr.row_ptr, csr.col_idx
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
    for name, t in (("row_ptr", row_ptr), ("col_idx", col_idx)):
        if t.dtype != torch.int32 or t.dim() != 1 or t.get_device() != dev \
                or not t.is_contiguous():
            raise ValueError(f"pull_rows: {name} must be a contiguous 1-D "
                             f"int32 tensor on {x.device}")
    n, f = row_ptr.shape[0] - 1, x.shape[1]
    out = torch.empty((n, f), dtype=torch.float32, device=x.device)
    if n == 0 or f == 0:
        return out.zero_()
    # x's address and row stride; out is a fresh allocation
    vec = lanes(f, x.data_ptr() | (4 * f))[0]
    if x.numel() // vec >= 1 << 32:
        raise ValueError(f"pull_rows: x holds {x.numel() // vec} vectors of "
                         f"{vec} floats, the kernel's offsets take < 2^32")
    n_blocks = _sm_count.get(dev)
    if n_blocks is None:
        n_blocks = _sm_count[dev] = \
            torch.cuda.get_device_properties(dev).multi_processor_count
    hub_rows, blk_hub, warp_part, parts = csr.plan(n_blocks)
    _LAUNCH(dev, row_ptr.data_ptr(), col_idx.data_ptr(), x.data_ptr(),
            out.data_ptr(), n, f, vec, L2_LAST_ROWS, n_blocks,
            hub_rows.data_ptr() if hub_rows.numel() else None,
            blk_hub.data_ptr(), warp_part.data_ptr(),
            parts.data_ptr() if parts.numel() else None)
    pull_rows.launches += 1
    return out


pull_rows.launches = 0
