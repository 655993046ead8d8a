"""How fast is the feature-row pull at GraphSAGE's shapes, and which lanes
and L2 policy serve it best? (CUDA only, raises without a card)

    python -m vectorgraphlibrary_tpu_torch.apps.exp_pull_rows [-s 20] [-e 16]
        [--sweep]

On RMAT-s (average degree e, seed 42), over the GATHER CSR as the graph
imports it and over its transpose (models/gnn.transposed_csr, the
backward's), with f32 rows from a seeded generator at F = 100 and 256
(ogbn-products' GraphSAGE widths; the transpose at 256):

  a) pull_rows with the module's constants, ms by CUDA events (median of
     3 means of 10), beside torch.sparse.mm of the CSR with ones (the
     one-call yardstick) and the bound (row_ptr, col_idx and x read once,
     out written once, at 3.35 TB/s); its result against the plain version
     in f64 (rtol 1e-5, atol 1e-6) and a second run bit for bit;
  b) with --sweep, the kernel with the module's constants set in turn to
     other values (pull_rows.L2_LAST_ROWS: the rows read with L2's
     evict_last; pull_rows.VEC: the most floats per lane), every result
     equal bit for bit to a)'s;
  c) the share of edges whose column lies below each hot-row count.

The imports are absolute, so the file also runs by its path against
another checkout of the package (PYTHONPATH=<checkout>), there without
--sweep. Prints the card's name and power limit, then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

from vectorgraphlibrary_tpu_torch.graph.device import import_graph
from vectorgraphlibrary_tpu_torch.io import generation
from vectorgraphlibrary_tpu_torch.models import gnn
from vectorgraphlibrary_tpu_torch.ops.cuda import pull_rows as prw

HBM_BYTES_PER_S = 3.35e12       # H100 SXM (NVIDIA data sheet)
HOT_COUNTS = (512, 1024, 1536, 2048, 4096, 16384, 65536, 262144)


def _ms(fn, reps: int = 10) -> float:
    """Median of 3 means of `reps` calls by CUDA events."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def _sweep(csr, x, want) -> dict:
    """ms with L2_LAST_ROWS and VEC set in turn to each value of a grid (the
    other at its default), each result checked bit for bit against `want`;
    the constants are restored after."""
    grid = [("L2_LAST_ROWS", l2) for l2 in (0, 1 << 15, 1 << 17, 1 << 30)]
    grid += [("VEC", vec) for vec in (2, 1)]
    res = {}
    for name, value in grid:
        default = getattr(prw, name)
        setattr(prw, name, value)
        try:
            got = prw.pull_rows(csr, x)
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"pull_rows with {name} = {value} "
                                     f"differs from the default's bits")
            res[f"{name} {value}"] = _ms(lambda: prw.pull_rows(csr, x))
        finally:
            setattr(prw, name, default)
    return res


def measure(scale: int = 20, degree: int = 16, sweep: bool = False,
            device: str = "cuda") -> dict:
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("exp_pull_rows measures the kernel on a CUDA "
                           "device")
    t0 = time.perf_counter()
    ec = generation.rmat(scale, degree, seed=42, weighted=False)
    g = import_graph(ec, device=device, build_route=False)
    dg = g.incoming
    csr = prw.RowCSR(dg.row_ptr, dg.col_idx)
    csr_t = prw.RowCSR(*gnn.transposed_csr(dg))
    torch.cuda.synchronize()
    e = dg.e
    gen = torch.Generator(device=device).manual_seed(55)
    res = {"graph": f"RMAT-{scale} degree {degree}, {e} edges, v_pad "
                    f"{g.v_pad}", "set_up_s": time.perf_counter() - t0,
           "hub_rows": csr.hubs.numel(), "hub_rows_transposed":
           csr_t.hubs.numel()}
    cols = dg.col_idx[:e]
    res["edge_share_below"] = {
        str(h): float((cols < h).sum()) / e for h in HOT_COUNTS}
    cols_t = csr_t.col_idx[:e]
    res["edge_share_below_transposed"] = {
        str(h): float((cols_t < h).sum()) / e for h in HOT_COUNTS}
    for label, c, f in (("f100", csr, 100), ("f256", csr, 256),
                        ("backward_f256", csr_t, 256)):
        x = torch.rand((g.v_pad, f), generator=gen, device=device)
        got = prw.pull_rows(c, x)
        again = prw.pull_rows(c, x)
        want = prw.pull_rows_ref(c.row_ptr, c.col_idx, x.double())
        n = c.row_ptr.shape[0] - 1
        r = {"ms": _ms(lambda: prw.pull_rows(c, x)),
             "max_abs_err": (got.double() - want).abs().max().item(),
             "within_rtol_1e-5": bool(torch.isclose(
                 got.double(), want, rtol=1e-5, atol=1e-6).all()),
             "bit_identical": torch.equal(got.view(torch.int32),
                                          again.view(torch.int32))}
        del want
        a = torch.sparse_csr_tensor(c.row_ptr, c.col_idx[:e],
                                    torch.ones(e, device=device),
                                    size=(n, x.shape[0]))
        r["sparse_mm_ms"] = _ms(lambda: torch.sparse.mm(a, x))
        r["bound_ms"] = ((n + 1) * 4 + e * 4 + x.numel() * 4 + n * f * 4) \
            / HBM_BYTES_PER_S * 1e3
        r["all_rows_from_memory_ms"] = e * f * 4 / HBM_BYTES_PER_S * 1e3
        if sweep:
            r["lanes"] = prw.lanes(f, x.data_ptr() | 4 * f)
            r["sweep"] = _sweep(c, x, got)
        res[label] = r
        del x, got, again, a
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-s", type=int, default=20, help="RMAT scale")
    ap.add_argument("-e", type=int, default=16, help="average degree")
    ap.add_argument("--sweep", action="store_true",
                    help="time other lanes and L2 policies too")
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    res = measure(args.s, args.e, args.sweep)
    res["card"] = smi.strip().splitlines()[0]
    print(res["card"])
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
