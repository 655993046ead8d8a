"""Microbenchmarks of the random-access primitives that bound the sparse
(frontier-driven) code paths, as PyTorch runs them on the card (port of
apps/ubench_prims.py): element and row gathers, scatters, sorts, scans and
a sorted search, at the JAX script's sizes (a 2^24 int32 table, 2^17
indices, numpy seed 0). Synthetic arrays, no graph: a sweep takes seconds.
These are the one-call PyTorch functions that the port's kernels are held
against where they compute the same function.

Timing: each op runs K times back to back between two CUDA events, each
run's input depending on the last run's output (the value the JAX script
chains through its loop carry), so the card cannot skip or overlap runs;
the time of an empty op (one tiny add) per run is subtracted, which leaves
what the op costs beyond one launch. Usage:

    python -m vectorgraphlibrary_tpu_torch.apps.ubench_prims [K]

The last line is one JSON object: {"device": <card name>, "k": K,
"empty_op_ms": ..., <op>: {"ms", "ns_per_elem"[, "gbs"]}, ...}.
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..runtime.timer import DeviceTimer


def timed_loop(op, carry, k: int, device) -> float:
    """carry = op(carry, i) for i < k after one untimed run; seconds per
    run."""
    carry = op(carry, 0)
    t = DeviceTimer(device).start()
    for i in range(k):
        carry = op(carry, i)
    return t.stop(carry) / k


def run(k: int = 20, device="cuda") -> dict:
    """The sweep on `device`; returns the results (the last line's
    object)."""
    device = torch.device(device)
    rng = np.random.default_rng(0)
    i32 = torch.int32

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=i32, device=device)

    base = timed_loop(lambda c, i: c + 1, zeros(), k, device)
    results = {"empty_op_ms": base * 1e3}

    def rec(name, secs, elems=None, bytes_moved=None):
        ms = max(secs - base, 0.0) * 1e3
        row = {"ms": round(ms, 4)}
        if elems:
            row["ns_per_elem"] = round(ms * 1e6 / elems, 3)
        if bytes_moved:
            row["gbs"] = round(bytes_moved / (ms * 1e-3) / 1e9, 2) \
                if ms > 0 else None
        results[name] = row
        print(name, row, flush=True)

    NT, NI = 1 << 24, 1 << 17          # table 16M, 131k indices
    table = up(rng.integers(0, 100, NT).astype(np.int32))
    idx = up(rng.integers(0, NT, NI).astype(np.int32))
    idx_sorted = torch.sort(idx).values

    # 1. element gather, random indices
    rec("gather_elem_2e17", timed_loop(
        lambda c, i: c + table.index_select(0, (idx + c) % NT),
        zeros(NI), k, device), NI)

    # 2. element gather, sorted indices
    rec("gather_elem_sorted_2e17", timed_loop(
        lambda c, i: c + table.index_select(
            0, torch.clamp(idx_sorted + c % 2, max=NT - 1)),
        zeros(NI), k, device), NI)

    # 3. row gathers: [R, W] tables, gather NR rows
    for rw, w in ((1 << 19, 32), (1 << 17, 128), (1 << 14, 1024)):
        t2 = table[: rw * w].view(rw, w)
        nr = 1 << 15
        ridx = up(rng.integers(0, rw, nr).astype(np.int32))
        rec(f"gather_rows_{nr}x{w}", timed_loop(
            lambda c, i, t2=t2, ridx=ridx, rw=rw: c + t2.index_select(
                0, (ridx + c[0, 0]) % rw),
            zeros(nr, w), k, device), nr, bytes_moved=nr * w * 4)

    # 4. lane shuffle along rows [rows, 1024] (take_along_axis)
    rows = 1 << 10
    perm = up(np.stack([rng.permutation(1024) for _ in range(rows)]))
    m2 = table[: rows * 1024].view(rows, 1024)
    rec("take_along_axis_1024x1024", timed_loop(
        lambda c, i: c + torch.gather(m2 + c[:, :1], 1, perm),
        zeros(rows, 1024), k, device), rows * 1024,
        bytes_moved=rows * 1024 * 4)

    # 5. element scatter (max-combine), random targets
    NV = 1 << 20
    sidx = up(rng.integers(0, NV, NI).astype(np.int64))
    vals = torch.ones(NI, dtype=i32, device=device)
    rec("scatter_max_2e17_into_2e20", timed_loop(
        lambda c, i: c.scatter_reduce(0, (sidx + i) % NV, vals, "amax"),
        zeros(NV), k, device), NI)

    # 6. element scatter small (2^15 into 2^15 words)
    NW = 1 << 15
    widx = up(rng.integers(0, NW, NW).astype(np.int64))
    wvals = torch.ones(NW, dtype=i32, device=device)
    rec("scatter_max_2e15_into_2e15", timed_loop(
        lambda c, i: c.scatter_reduce(0, (widx + i) % NW, wvals, "amax"),
        zeros(NW), k, device), NW)

    # 7. row scatter: max 2^15 rows of 32 into [2^19, 32]
    rw, nr = 1 << 19, 1 << 15
    rvals = torch.ones((nr, 32), dtype=i32, device=device)
    ridx = up(rng.integers(0, rw, nr).astype(np.int64))
    rec(f"scatter_rows_{nr}x32", timed_loop(
        lambda c, i: c.scatter_reduce(
            0, ((ridx + i) % rw)[:, None].expand(nr, 32), rvals, "amax"),
        zeros(rw, 32), k, device), nr, bytes_moved=nr * 32 * 4)

    # 8. sorts: keys alone, and keys carrying a payload
    for n in (1 << 17, 1 << 20):
        keys = up(rng.integers(0, 1 << 30, n).astype(np.int32))
        rec(f"sort_{n}", timed_loop(
            lambda c, i, keys=keys: torch.sort(keys + c[0]).values + c,
            zeros(n), k, device), n)
        pay = up(rng.integers(0, 1 << 30, n).astype(np.int32))

        def sort_kv(c, i, keys=keys, pay=pay):
            order = torch.sort(keys + c[0]).indices
            return pay[order] + c
        rec(f"sort_kv_{n}", timed_loop(sort_kv, zeros(n), k, device), n)

    # 9. scans
    for n in (1 << 17, 1 << 20):
        x = up(rng.integers(0, 3, n).astype(np.int32))
        rec(f"cumsum_{n}", timed_loop(
            lambda c, i, x=x: c + torch.cumsum(x + c[0], 0, dtype=i32),
            zeros(n), k, device), n)
        rec(f"cummax_{n}", timed_loop(
            lambda c, i, x=x: torch.maximum(
                c, torch.cummax(x + c[0], 0).values),
            zeros(n), k, device), n)

    # 10. searchsorted: 2^17 queries in a sorted 2^20 table
    st = torch.sort(up(rng.integers(0, 1 << 30, 1 << 20).astype(
        np.int32))).values
    q = up(rng.integers(0, 1 << 30, NI).astype(np.int32))
    rec("searchsorted_2e17_in_2e20", timed_loop(
        lambda c, i: c + torch.searchsorted(st, q + c[0], out_int32=True),
        zeros(NI), k, device), NI)

    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else str(device)
    return {"device": name, "k": k, **results}


def main() -> int:
    k = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    if not torch.cuda.is_available():
        print("ubench_prims: no CUDA device is available", file=sys.stderr)
        return 1
    print(json.dumps(run(k)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
