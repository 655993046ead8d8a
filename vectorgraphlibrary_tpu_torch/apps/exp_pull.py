"""Where does the CSR pull spend its time on the card, and how does it
compare with another checkout's kernel? (CUDA only, raises without a card)

    python -m vectorgraphlibrary_tpu_torch.apps.exp_pull [-s 18] [-e 32] [--mf] [-load G.el_container]

On RMAT-s (average degree e, seed 42), or with -load on the graph of an
.el_container file (such as apps/make_lj_replica.py's), with values from a
seeded generator,
device ms per call by torch.profiler (the kernels' durations, the mean of
10 calls; where a call runs two kernels, both count):

  a) the whole pull over the GATHER and SCATTER CSRs: f32 add (GATHER also
     without self-loops, as PageRank pulls), i32 min, i32 or (MS-BFS's
     words), int8 any01, and with
     weights in [1, 100) f32 min of x + w and max of min(x, w), and f32 add
     of x + w with w = 0 (the unweighted function by the weighted kernel);
  b) f32 add over each degree class of the GATHER CSR alone, as the row
     range that the graph's classes give (wide huge rows, other huge rows,
     each bucket, then the rest with the empty rows and the padding), and
     over the longest row alone;
  c) torch.mv of each CSR tensor with ones (cuSPARSE), the one-call
     yardstick for the f32 add;
  d) each case's bytes bound: row_ptr, col_idx and w of its slots read once,
     x read once, out written once, at the H100's 3.35 TB/s;
  e) with --mf, over the max-flow residual CSR of the graph as apps/mf.py
     prepares it: the BFS level pull (i32 min of max(x, w), 30 % of the
     sources active) and segment_reduce (i32 min, f32 add).

The imports are absolute, so the file also runs by its path against
another checkout of the package (PYTHONPATH=<checkout>); a checkout whose
pull_reduce takes degree-class groups (ops.advance.row_groups) in place of
a plan is driven with those. Prints the card's name and power limit, then
one JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

from vectorgraphlibrary_tpu_torch.graph.device import import_graph
from vectorgraphlibrary_tpu_torch.io import generation
from vectorgraphlibrary_tpu_torch.models.bfs import G, S
from vectorgraphlibrary_tpu_torch.ops import advance
from vectorgraphlibrary_tpu_torch.ops.cuda import pull_reduce as pl

HBM_BYTES_PER_S = 3.35e12       # H100 SXM (NVIDIA data sheet)
SEED = 42


def _ms(fn, reps: int = 10) -> float:
    """Device time of one call: the kernels' durations by torch.profiler
    over `reps` calls (events would time the host's launches instead, which
    take longer than a small class's kernel)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / reps / 1e3


def _classes(dg) -> list:
    """The GATHER CSR's degree classes as (first row, end row, threads per
    row of the degree-class schedule that the pull ran before the plan):
    wide huge rows (over 4 chunks) a block of 512, other huge rows a warp,
    each bucket width / 8 threads (1 to 32), the rest one thread;
    neighbours with the same thread count merge, as they did there."""
    out = []

    def add(end, g):
        start = out[-1][1] if out else 0
        if end == start:
            return
        if out and out[-1][2] == g:
            out[-1] = (out[-1][0], end, g)
        else:
            out.append((start, end, g))
    if dg.huge is not None:
        degs = dg.degrees[:dg.huge.n_rows]
        add(int((degs > 4 * dg.huge.chunk_w).sum()), 512)
        add(dg.huge.n_rows, 32)
    for b in dg.buckets:
        add(b.row_start + b.rows, min(max(b.width // 8, 1), 32))
    add(dg.v_pad, 1)
    return out


PLAN = hasattr(pl, "make_plan")     # the checkout schedules by a plan


def _schedule(dg):
    """The checkout's schedule of dg's whole CSR, as its advance makes it."""
    return advance.pull_plan(dg) if PLAN else advance.row_groups(dg)


def _pull(dg, rows, x, op, excl=False, w=None, wop=None):
    """A call of the checkout's pull_reduce over rows [r0, r1) of dg's CSR
    (rows None: all of them, as its advance runs it) with its own
    schedule."""
    if rows is None:
        rp, sched = dg.row_ptr, _schedule(dg)
    else:
        r0, r1, g = rows
        rp = dg.row_ptr[r0:r1 + 1]
        sched = pl.make_plan(rp) if PLAN else ((r1 - r0, g),)
    return lambda: pl.pull_reduce(rp, dg.col_idx, x, op, excl, sched,
                                  weights=w, weight_op=wop)


def _bound_ms(dg, rows, x, w=None) -> float:
    r0, r1 = rows[:2] if rows is not None else (0, dg.v_pad)
    slots = int(dg.row_ptr[r1] - dg.row_ptr[r0])
    per_slot = 4 + (0 if w is None else w.element_size())
    nbytes = (r1 - r0 + 1) * 4 + slots * per_slot \
        + (x.shape[0] + r1 - r0) * x.element_size()
    return nbytes / HBM_BYTES_PER_S * 1e3


def _case(res, name, dg, rows, x, op, excl=False, w=None, wop=None):
    res[name] = {"ms": _ms(_pull(dg, rows, x, op, excl, w, wop)),
                 "bound_ms": _bound_ms(dg, rows, x, w)}


def _mf_cases(ec, dev, res) -> None:
    from vectorgraphlibrary_tpu_torch.apps import mf as mf_app
    from vectorgraphlibrary_tpu_torch.models import mf
    ec2 = mf_app.prepare(ec, SEED)
    g2, res0 = mf.build_residual(ec2, dev)[:2]
    dg = g2.incoming
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    iota = torch.arange(dg.e_pad, dtype=torch.int32, device=dev)
    w = torch.where(res0 > mf._EPS, iota, mf._BIG)
    on = torch.rand(g2.v_pad, generator=gen, device=dev) < 0.3
    x = torch.where(on, 0, torch.iinfo(torch.int32).max).to(torch.int32)
    _case(res, f"residual G i32 min of max(x, w), 30 % active "
          f"({dg.e} slots)", dg, None, x, "min", False, w, "max")
    cols = dg.col_idx[:dg.e].long()
    mi = torch.where(on[cols], w[:dg.e], torch.iinfo(torch.int32).max)
    mf32 = torch.rand(dg.e_pad, generator=gen, device=dev)
    sched = _schedule(dg)
    for label, m, op in (("i32 min", mi.contiguous(), "min"),
                         ("f32 add", mf32, "add")):
        res[f"residual segment_reduce {label}"] = {
            "ms": _ms(lambda: pl.segment_reduce(dg.row_ptr, m, op, sched)),
            "bound_ms": ((g2.v_pad + 1) * 4 + dg.e * m.element_size()
                         + g2.v_pad * m.element_size())
            / HBM_BYTES_PER_S * 1e3}


def measure(scale: int = 18, degree: int = 32, with_mf: bool = False,
            device: str = "cuda", ec=None) -> dict:
    """The cases (module doc) on RMAT-scale, or on `ec` where given."""
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("exp_pull measures the kernel on a CUDA device")
    if ec is None:
        ec = generation.rmat(scale, degree, seed=SEED, weighted=False)
    g = import_graph(ec, device=device, build_route=False)
    gen = torch.Generator(device=device).manual_seed(SEED)
    n = g.v_pad
    xf = torch.rand(n, device=device, generator=gen)
    xi = torch.randint(-2**31, 2**31 - 1, (n,), device=device, generator=gen,
                       dtype=torch.int32)
    xb = torch.randint(0, 2, (n,), device=device, generator=gen,
                       dtype=torch.int8)
    dist = torch.rand(n, device=device, generator=gen) * 300
    dist[torch.rand(n, device=device, generator=gen) < 0.3] = torch.inf
    res: dict = {}
    for d, tag in ((G, "G"), (S, "S")):
        dg = g.direction(d)
        w = torch.rand(dg.e_pad, device=device, generator=gen) * 99 + 1
        if d == G:
            _case(res, "G f32 add excl", dg, None, xf, "add", True)
        _case(res, f"{tag} f32 add", dg, None, xf, "add")
        _case(res, f"{tag} i32 min", dg, None, xi, "min")
        _case(res, f"{tag} i32 or", dg, None, xi, "or")
        _case(res, f"{tag} i8 any01", dg, None, xb, "any01")
        _case(res, f"{tag} f32 min of x + w", dg, None, dist, "min", False,
              w, "add")
        _case(res, f"{tag} f32 max of min(x, w)", dg, None, dist, "max",
              False, w, "min")
        # the f32 add through the weighted kernel, w = 0: the same function
        # as the unweighted add over 4 more bytes a slot
        _case(res, f"{tag} f32 add of x + w, w = 0", dg, None, xf, "add",
              False, torch.zeros_like(w), "add")
        a = torch.sparse_csr_tensor(dg.row_ptr, dg.col_idx[:dg.e],
                                    torch.ones(dg.e, device=device),
                                    size=(n, n))
        res[f"{tag} torch.mv"] = {"ms": _ms(lambda: torch.mv(a, xf))}
        del a
    dg = g.direction(G)
    for r0, r1, threads in _classes(dg):
        _case(res, f"G f32 add rows {r0}-{r1} (x{threads} before the plan)",
              dg, (r0, r1, threads), xf, "add")
    _case(res, f"G f32 add row 0 ({int(dg.degrees[0])} edges)", dg,
          (0, 1, 512), xf, "add")
    if with_mf:
        _mf_cases(ec, device, res)
    return res


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-s", type=int, default=18)
    p.add_argument("-e", type=int, default=32)
    p.add_argument("--mf", action="store_true",
                   help="also time the max-flow residual CSR's pulls")
    p.add_argument("-load", default=None,
                   help="an .el_container graph in place of RMAT-s")
    args = p.parse_args()
    ec = None
    if args.load:
        from vectorgraphlibrary_tpu_torch.io.edges_container import (
            EdgesContainer)
        ec = EdgesContainer.load_from_binary_file(args.load)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "plan": PLAN,
                      "graph": args.load or f"rmat{args.s}_{args.e}",
                      "ms": measure(args.s, args.e, args.mf, ec=ec)}))


if __name__ == "__main__":
    main()
