"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Phases, each of which must pass (any failure exits non-zero and prints no
result line):

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc builds the port's kernels from vectorgraphlibrary_tpu_torch/csrc;
3. kernel: route_gather_finish against its plain PyTorch version on the card,
   bit for bit, on a random permutation of n = 2^24 slots in both directions
   (f32 with every finish, i32 and int8), plus kernel and plain times;
4. slice: PageRank on RMAT-18 (average degree 32, seed 42, unweighted, 100
   iterations, no convergence test) through import_graph and vgl_page_rank;
   the ranks must pass verify_ranking_results against seq_page_rank, the
   route kernel must have launched exactly 201 times in the vgl_page_rank
   call, and the MTEPS (|E| * 100 / time) of three more runs are printed;
5. kernel: scatter_combine against its plain version on the card, bit for
   bit, into V = 2^20 int32 vertices from 2^15, 2^16 and 2^17 destinations
   (an eighth of them dropped), all dropped, and none; min and max of random
   int32 messages and or of message 1; kernel and plain times, and the three
   variants of apps/exp_push.py;
6. slice: BFS on RMAT-20 (average degree 16, seed 42, unweighted) through
   import_graph and the BFS entry points: vgl_bfs_device on 8 roots (each
   with error count 0 against seq_top_down, scatter_combine launched twice
   per top-down level and the route kernel in the bottom-up levels),
   vgl_top_down and vgl_bfs (-bu) on one root, vgl_msbfs on 64 roots (4
   rows checked); per-root DO GTEPS and MS-BFS aggregate GTEPS, medians of 3;
7. kernel: lane_shuffle against its plain version on the card, bit for bit,
   at [2^17, 128] (n = 2^24): random per-row permutations of f32, i32 and
   int8 values, and the forward and inverse lane indices of the phase-4
   RMAT-18 advance route from the port's Beneš router (timed); kernel, plain
   and torch.gather times;
8. slice: persistence on the phase-4 RMAT-18 graph: save (uncompressed, to a
   temporary directory), load on the card (exactly 8 lane_shuffle launches:
   two per plan), every plan's indices and flags and every tile equal to the
   phase-4 graph's; vgl_page_rank (100 iterations) on the loaded graph equal
   to the phase-4 ranks and error count 0 against seq_page_rank; one
   vgl_bfs_device root equal to the phase-4 graph's levels; the same load
   from a slim copy of the file (word masks only, as a TPU host saves it).

The line before the last is {"kernels": [...]}: for each kernel its launches
on each path, its error against the plain version, and its time, its plain
version's time, the one-call PyTorch time (library_ms) and its bound
(bound_ms: the bytes it must move at the H100's 3.35 TB/s) at the main
path's shapes. The last line is {"ok": true, "device": {...}}. --profile DIR also writes torch.profiler
tables of one 10-iteration PageRank run and one DO-BFS root to DIR (not part
of the default run).
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SCALE, DEGREE, SEED, ITERS = 18, 32, 42, 100
N_KERNEL = 1 << 24
BFS_SCALE, BFS_DEGREE, BFS_ROOTS, MS_ROOTS = 20, 16, 8, 64
DEVICE = "cuda"
REPLACES = ("vectorgraphlibrary_tpu/ops/pallas/route_fused.py:157 (_mid_kernel), "
            "vectorgraphlibrary_tpu/ops/pallas/route_fused.py:202 (_big_kernel)")
REPLACES_SCATTER = "apps/exp_push.py:59 (make_c), apps/exp_push.py:41 (_kern)"
REPLACES_LANE = "vectorgraphlibrary_tpu/ops/route.py:146 (_lane_shuffle_tpu)"
# H100 SXM device memory rate (NVIDIA data sheet); every kernel here is
# bound by the bytes it moves, far below the card's operation rates
HBM_BYTES_PER_S = 3.35e12


def _bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def _smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def _cuda_ms(fn, reps: int = 10) -> float:
    """Mean device time of one call over `reps` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _check(rg, label: str, x, idx, kw) -> float:
    """Kernel against plain version on the same inputs; the tolerance is
    zero: the outputs must be equal bit for bit. Returns the max abs error."""
    got = rg.route_gather_finish(x, idx, **kw)
    want = rg.route_gather_finish_ref(x, idx, **kw)
    torch.cuda.synchronize()
    err = (got.double() - want.double()).abs().max().item()
    ok = got.dtype == want.dtype and torch.equal(_bits(got), _bits(want))
    print(f"  kernel {label}: {'bit-exact' if ok else 'MISMATCH'} "
          f"(max abs err {err})")
    if not ok:
        raise AssertionError(f"route_gather_finish != plain version: {label}")
    return err


def phase_kernel(rg) -> tuple[float, float, float]:
    """Kernel vs plain version at n = 2^24; returns (max_abs_err, ms, plain_ms)
    of the f32 forward route with the PR finish."""
    rng = np.random.default_rng(SEED)
    n = N_KERNEL
    perm = rng.permutation(n)
    inv = np.argsort(perm)
    dev = torch.device(DEVICE)
    idx = {False: torch.from_numpy(perm.astype(np.int32)).to(dev),
           True: torch.from_numpy(inv.astype(np.int32)).to(dev)}
    flags = {d: torch.from_numpy(rng.integers(0, 4, n).astype(np.uint8)).to(dev)
             for d in (False, True)}
    xf = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    wf = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    xi = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, n,
                                       dtype=np.int64).astype(np.int32)).to(dev)
    xb = torch.from_numpy(rng.integers(-128, 128, n).astype(np.int8)).to(dev)
    wb = torch.from_numpy(rng.integers(-128, 128, n).astype(np.int8)).to(dev)
    cases = []
    for inverse in (False, True):
        for wop in (None, "add", "min", "max", "mul"):
            for excl in (False, True):
                cases.append((f"f32 wop={wop} excl={excl}", xf, inverse,
                              dict(flags=flags[inverse], weight_op=wop,
                                   weights=None if wop is None else wf,
                                   exclude_self_loops=excl, ident=-7.5)))
        cases.append(("i32 no finish", xi, inverse, {}))
        cases.append(("i8 no finish", xb, inverse, {}))
        cases.append(("i8 add excl", xb, inverse,
                      dict(flags=flags[inverse], weight_op="add", weights=wb,
                           exclude_self_loops=True, ident=0)))
    max_err = max(_check(rg, f"{'inv' if inverse else 'fwd'} {name}", x,
                         idx[inverse], kw)
                  for name, x, inverse, kw in cases)

    kw = dict(flags=flags[False], exclude_self_loops=True, ident=0.0)
    ks, ps = [], []
    for _ in range(3):
        ks.append(_cuda_ms(lambda: rg.route_gather_finish(xf, idx[False], **kw)))
        ps.append(_cuda_ms(
            lambda: rg.route_gather_finish_ref(xf, idx[False], **kw)))
    k_ms, p_ms = statistics.median(ks), statistics.median(ps)
    print(f"  random perm n=2^24 f32 fwd finish: kernel {k_ms:.4f} ms "
          f"(runs {', '.join(f'{t:.4f}' for t in ks)}), plain "
          f"{p_ms:.4f} ms (runs {', '.join(f'{t:.4f}' for t in ps)})")
    return max_err, k_ms, p_ms


def phase_pagerank(rg, smi: str):
    from vectorgraphlibrary_tpu_torch.graph.device import import_graph
    from vectorgraphlibrary_tpu_torch.graph.vertices import as_original_numpy
    from vectorgraphlibrary_tpu_torch.io import generation
    from vectorgraphlibrary_tpu_torch.models import pr
    from vectorgraphlibrary_tpu_torch.ops.route import FinishSpec, apply_route
    from vectorgraphlibrary_tpu_torch.utils.verify import verify_ranking_results

    t0 = time.perf_counter()
    ec = generation.rmat(SCALE, DEGREE, seed=SEED, weighted=False)
    t1 = time.perf_counter()
    graph = import_graph(ec, device=DEVICE)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    plan = graph.advance_route
    print(f"  RMAT-{SCALE}: |V|={graph.v} |E|={graph.e}, advance route "
          f"n={plan.n}, generate {t1 - t0:.2f} s, import {t2 - t1:.2f} s")

    torch.cuda.reset_peak_memory_stats()
    rg.route_gather_finish.launches = 0
    t0 = time.perf_counter()
    ranks, iters = pr.vgl_page_rank(graph, max_iterations=ITERS,
                                    use_convergence=False)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = rg.route_gather_finish.launches
    peak = torch.cuda.max_memory_allocated()
    print(f"  vgl_page_rank: {iters} iterations, {launches} route-gather "
          f"launches, first run {first_s:.4f} s, peak device memory "
          f"{peak / 2**20:.1f} MiB")
    if launches != 1 + 2 * ITERS:
        raise AssertionError(f"expected {1 + 2 * ITERS} launches, got {launches}")
    vals = ranks.values
    if vals.shape != (graph.v_pad,) or not bool(torch.isfinite(vals).all()):
        raise AssertionError("ranks are not finite values of shape [v_pad]")
    got = as_original_numpy(ranks, graph)
    want = pr.seq_page_rank(ec, max_iterations=ITERS, use_convergence=False)
    errors = verify_ranking_results(got, want)
    if errors:
        raise AssertionError(f"PageRank check: error count {errors}")

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        last, _ = pr.vgl_page_rank(graph, max_iterations=ITERS,
                                   use_convergence=False)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    # two runs on one graph give the same bits unless some op on the path
    # sums in a varying order; phase 8 holds the loaded graph to that
    deterministic = torch.equal(vals, last.values)
    print(f"  two vgl_page_rank runs on one graph: "
          f"{'bit-identical' if deterministic else 'DIFFER'}")
    rates = sorted(ec.edges_count * ITERS / t / 1e6 for t in times)
    print(f"  PR RMAT-{SCALE} MTEPS median {rates[1]:.1f} (min {rates[0]:.1f}, "
          f"max {rates[2]:.1f}; runs {', '.join(f'{t:.4f}' for t in times)} s) "
          f"on {smi}")

    # the main path's own route calls, kernel against plain version: the
    # advance route with the PR finish, the G->S vertex route on f32 ranks,
    # the inverse vertex route on int32 out-degrees
    fin = FinishSpec(ident=0.0, exclude_self_loops=True)
    vplan = graph.vertex_route_s_from_g
    msgs = torch.rand(plan.n, device=DEVICE)
    max_err = max(
        _check(rg, f"RMAT-{SCALE} advance route f32 fwd finish", msgs,
               plan.fwd_idx, dict(flags=plan.flags_fwd,
                                  exclude_self_loops=True, ident=0.0)),
        _check(rg, f"RMAT-{SCALE} vertex route f32 fwd",
               torch.rand(vplan.n, device=DEVICE), vplan.fwd_idx, {}),
        _check(rg, f"RMAT-{SCALE} vertex route i32 inv",
               graph.outgoing.degrees, vplan.inv_idx, {}))
    ks, ps = [], []
    for _ in range(3):
        ks.append(_cuda_ms(lambda: apply_route(plan, msgs, finish=fin)))
        ps.append(_cuda_ms(lambda: rg.route_gather_finish_ref(
            msgs, plan.fwd_idx, flags=plan.flags_fwd, exclude_self_loops=True,
            ident=0.0)))
    k_ms, p_ms = statistics.median(ks), statistics.median(ps)
    # one-call PyTorch: the same gather without the finish
    lib_ms = statistics.median(
        _cuda_ms(lambda: torch.index_select(msgs, 0, plan.fwd_idx))
        for _ in range(3))
    # bytes it must move: flags and out for every slot, idx and x only for
    # the slots the finish keeps (valid, not a self-loop)
    f = plan.flags_fwd
    kept = int(((f & 1 != 0) & (f & 2 == 0)).sum())
    bound = _bound_ms(plan.n * (1 + 4) + kept * (4 + 4))
    print(f"  RMAT-{SCALE} advance route f32 fwd finish: kernel {k_ms:.4f} ms "
          f"(runs {', '.join(f'{t:.4f}' for t in ks)}), plain {p_ms:.4f} ms "
          f"(runs {', '.join(f'{t:.4f}' for t in ps)}), index_select "
          f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({kept} of {plan.n} slots "
          f"kept) on {smi}")
    return dict(graph=graph, ec=ec, ranks=vals, oracle=want,
                deterministic=deterministic, launches=launches,
                max_err=max_err, ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                bound_ms=bound)


def _median3(label: str, unit: str, values, smi: str) -> float:
    v = sorted(values)
    print(f"  {label}: median {v[1]:.4f} {unit} (min {v[0]:.4f}, max "
          f"{v[2]:.4f}) on {smi}")
    return v[1]


def phase_scatter(scm, smi: str) -> dict:
    """scatter_combine against its plain version at the BFS push's shapes
    (V = 2^20 vertices); returns the max abs error and the times of the BFS
    combine (min) at the largest default tier, 2^16 messages."""
    from vectorgraphlibrary_tpu_torch.apps import exp_push
    rng = np.random.default_rng(SEED)
    v = 1 << 20
    dev = torch.device(DEVICE)

    def i32(n):
        return torch.from_numpy(rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64)
                                .astype(np.int32)).to(dev)
    out = i32(v)
    cases = []
    for lg in (15, 16, 17):
        d = rng.integers(0, v, 1 << lg)
        d[rng.permutation(1 << lg)[:(1 << lg) // 8]] = v
        cases.append((f"ecap=2^{lg}", torch.from_numpy(d.astype(np.int32))))
    cases.append(("all dropped", torch.full((1 << 12,), v, dtype=torch.int32)))
    cases.append(("ecap=0", torch.zeros(0, dtype=torch.int32)))
    max_err = 0.0
    for label, idx in cases:
        idx = idx.to(dev)
        for op, msg in (("min", i32(idx.shape[0])), ("max", i32(idx.shape[0])),
                        ("or", 1)):
            got = scm.scatter_combine(out, idx, msg, op)
            want = scm.scatter_combine_ref(out, idx, msg, op)
            torch.cuda.synchronize()
            err = (got.double() - want.double()).abs().max().item()
            ok = torch.equal(got, want)
            print(f"  scatter_combine {label} {op}: "
                  f"{'bit-exact' if ok else 'MISMATCH'} (max abs err {err})")
            if not ok:
                raise AssertionError(f"scatter_combine != plain version: "
                                     f"{label} {op}")
            max_err = max(max_err, err)

    idx = cases[1][1].to(dev)
    msg = i32(idx.shape[0])
    ks, ps = [], []
    for _ in range(3):
        ks.append(_cuda_ms(lambda: scm.scatter_combine(out, idx, msg, "min")))
        ps.append(_cuda_ms(lambda: scm.scatter_combine_ref(out, idx, msg, "min")))
    k_ms = _median3("scatter_combine min 2^16 -> 2^20, kernel", "ms", ks, smi)
    p_ms = _median3("scatter_combine min 2^16 -> 2^20, plain", "ms", ps, smi)
    # one-call PyTorch: scatter_reduce of the in-range messages
    keep = (idx >= 0) & (idx < v)
    idx_in, msg_in = idx[keep].long(), msg[keep]
    lib_ms = _median3("scatter_combine min 2^16 -> 2^20, scatter_reduce", "ms",
                      [_cuda_ms(lambda: torch.scatter_reduce(
                          out, 0, idx_in, msg_in, "amin")) for _ in range(3)],
                      smi)
    # bytes it must move: out read and the copy written (4 B each per
    # vertex), every index, the messages that land
    bound = _bound_ms(8 * v + 4 * idx.shape[0] + 4 * idx_in.shape[0])
    print(f"  scatter_combine bound {bound:.4f} ms")
    res = exp_push.measure(DEVICE)
    print("  exp_push (ms per scatter of message 1 into 2^20): "
          + ", ".join(f"{k} {t:.4f}" for k, t in res.items()))
    return dict(max_err=max_err, ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                bound_ms=bound)


def phase_bfs(rg, scm, smi: str):
    """BFS on RMAT-20 through the port's entry points; returns the graph and
    the two kernels' launch counts over the 8 vgl_bfs_device calls."""
    from vectorgraphlibrary_tpu_torch.graph.device import import_graph
    from vectorgraphlibrary_tpu_torch.graph.vertices import (VertexArray,
                                                             as_original_numpy)
    from vectorgraphlibrary_tpu_torch.io import generation
    from vectorgraphlibrary_tpu_torch.models import bfs, common
    from vectorgraphlibrary_tpu_torch.utils.verify import verify_results

    t0 = time.perf_counter()
    ec = generation.rmat(BFS_SCALE, BFS_DEGREE, seed=SEED, weighted=False)
    t1 = time.perf_counter()
    graph = import_graph(ec, device=DEVICE)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"  RMAT-{BFS_SCALE}: |V|={graph.v} |E|={graph.e}, advance route "
          f"n={graph.advance_route.n}, generate {t1 - t0:.2f} s, import "
          f"{t2 - t1:.2f} s")

    def check(label, values, src):
        if values.shape != (graph.v_pad,) or values.dtype != torch.int32:
            raise AssertionError(f"{label}: levels are not int32 [v_pad]")
        got = as_original_numpy(VertexArray(values=values, direction=bfs.S),
                                graph)
        errors = verify_results(got, bfs.seq_top_down(ec, src))
        if errors:
            raise AssertionError(f"{label} root {src}: error count {errors}")

    roots = [common.select_random_source(ec, seed=100 + s)
             for s in range(BFS_ROOTS)]
    torch.cuda.reset_peak_memory_stats()
    sc_total = rg_total = 0
    for src in roots:
        trace = []
        scm.scatter_combine.launches = 0
        rg.route_gather_finish.launches = 0
        t0 = time.perf_counter()
        lv = bfs.vgl_bfs_device(graph, src, trace=trace)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n_sc = scm.scatter_combine.launches
        n_rg = rg.route_gather_finish.launches
        td = sum(t[0] == "td" for t in trace)
        print(f"  vgl_bfs_device root {src}: {len(trace)} levels ({td} "
              f"top-down, {len(trace) - td} bottom-up), scatter_combine "
              f"launches {n_sc}, route_gather launches {n_rg}, {dt:.4f} s")
        if n_sc != 2 * td:
            raise AssertionError(f"scatter_combine launched {n_sc} times, "
                                 f"expected 2 x {td} top-down levels")
        if (n_rg > 0) != (td < len(trace)):
            raise AssertionError(f"route_gather launched {n_rg} times in "
                                 f"{len(trace) - td} bottom-up levels")
        sc_total += n_sc
        rg_total += n_rg
        check("vgl_bfs_device", lv.values, src)
    if sc_total == 0 or rg_total == 0:
        raise AssertionError("the DO-BFS run did not launch both kernels")
    check("vgl_top_down", bfs.vgl_top_down(graph, roots[0]).values, roots[0])
    check("vgl_bfs -bu", bfs.vgl_bfs(graph, roots[0], alpha=1e-9).values,
          roots[0])

    ms_roots = [common.select_random_source(ec, seed=500 + s)
                for s in range(MS_ROOTS)]
    rg.route_gather_finish.launches = 0
    lv_ms = bfs.vgl_msbfs(graph, ms_roots).values
    torch.cuda.synchronize()
    print(f"  vgl_msbfs {MS_ROOTS} roots: route_gather launches "
          f"{rg.route_gather_finish.launches}")
    if lv_ms.shape != (MS_ROOTS, graph.v_pad):
        raise AssertionError(f"vgl_msbfs levels of shape {tuple(lv_ms.shape)}")
    for i in (0, MS_ROOTS // 3, 2 * MS_ROOTS // 3, MS_ROOTS - 1):
        check(f"vgl_msbfs row {i}", lv_ms[i], ms_roots[i])

    # timing: graph500-style protocols of bench.py (warmed up on other roots)
    bfs.vgl_bfs_device_multi(graph, [common.select_random_source(ec, seed=s)
                                     for s in range(BFS_ROOTS)])
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bfs.vgl_bfs_device_multi(graph, roots)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / BFS_ROOTS)
    print(f"  DO-BFS s per root: {', '.join(f'{t:.5f}' for t in times)}")
    _median3(f"DO-BFS RMAT-{BFS_SCALE} GTEPS per root", "GTEPS",
             [graph.e / t / 1e9 for t in times], smi)
    bfs.vgl_msbfs(graph, [common.select_random_source(ec, seed=s)
                          for s in range(MS_ROOTS)])
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lv_ms = bfs.vgl_msbfs(graph, ms_roots).values
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    edges = int(torch.where(lv_ms > 0, graph.outgoing.degrees, 0)
                .sum(dtype=torch.int64))
    print(f"  MS-BFS s per {MS_ROOTS} roots: "
          f"{', '.join(f'{t:.5f}' for t in times)}; traversed edges {edges}")
    _median3(f"MS-BFS RMAT-{BFS_SCALE} aggregate GTEPS", "GTEPS",
             [edges / t / 1e9 for t in times], smi)
    print(f"  BFS peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB on {smi}")
    return graph, roots[0], sc_total, rg_total


def phase_lane_shuffle(ls, graph, smi: str) -> dict:
    """lane_shuffle against its plain version at the RMAT-18 advance route's
    shape, [2^17, 128] (n = 2^24): random per-row permutations of f32, i32
    and int8 values, and the lane indices of that route from the port's
    router. Times the main path's call (the loader routes int32 indices
    through the advance plan's lanes)."""
    from vectorgraphlibrary_tpu_torch.ops.route import make_benes_plan
    dev = torch.device(DEVICE)
    n = graph.advance_route.n
    rows = n // 128
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rand_idx = torch.rand(rows, 128, device=dev, generator=gen).argsort(
        dim=1).int()
    xs = {"f32": torch.randn(rows, 128, device=dev, generator=gen),
          "i32": torch.randint(-2**31, 2**31 - 1, (rows, 128), device=dev,
                               generator=gen).int(),
          "i8": torch.randint(-128, 128, (rows, 128), device=dev,
                              generator=gen).to(torch.int8)}
    t0 = time.perf_counter()
    bplan = make_benes_plan(graph.advance_route.fwd_idx.cpu().numpy(),
                            device=DEVICE)
    router_s = time.perf_counter() - t0
    print(f"  Beneš router on the RMAT-{SCALE} advance route (n = {n}): "
          f"{router_s:.2f} s on the host")
    cases = [(f"random perm {k}", x, rand_idx) for k, x in xs.items()]
    cases += [(f"RMAT-{SCALE} {lanes} {k}", xs[k], getattr(bplan, lanes))
              for lanes in ("lane_idx", "lane_inv") for k in ("f32", "i32")]
    max_err = 0.0
    for label, x, idx in cases:
        got = ls.lane_shuffle(x, idx)
        want = ls.lane_shuffle_ref(x, idx)
        torch.cuda.synchronize()
        err = (got.double() - want.double()).abs().max().item()
        ok = got.dtype == want.dtype and torch.equal(_bits(got), _bits(want))
        print(f"  lane_shuffle {label}: {'bit-exact' if ok else 'MISMATCH'} "
              f"(max abs err {err})")
        if not ok:
            raise AssertionError(f"lane_shuffle != plain version: {label}")
        max_err = max(max_err, err)

    x, idx = xs["i32"], bplan.lane_idx
    idx64 = idx.long()
    k_ms = _median3(f"lane_shuffle RMAT-{SCALE} lanes i32, kernel", "ms",
                    [_cuda_ms(lambda: ls.lane_shuffle(x, idx))
                     for _ in range(3)], smi)
    p_ms = _median3(f"lane_shuffle RMAT-{SCALE} lanes i32, plain", "ms",
                    [_cuda_ms(lambda: ls.lane_shuffle_ref(x, idx))
                     for _ in range(3)], smi)
    lib_ms = _median3(f"lane_shuffle RMAT-{SCALE} lanes i32, torch.gather", "ms",
                      [_cuda_ms(lambda: torch.gather(x, 1, idx64))
                       for _ in range(3)], smi)
    bound = _bound_ms(n * (4 + 4 + 4))     # x, idx, out
    print(f"  lane_shuffle bound {bound:.4f} ms")
    return dict(max_err=max_err, ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                bound_ms=bound, router_s=router_s)


def _graph_tensors(obj, prefix=""):
    """A port graph as {path: tensor or scalar}."""
    if isinstance(obj, torch.Tensor):
        return {prefix: obj}
    if dataclasses.is_dataclass(obj):
        out = {}
        for f in dataclasses.fields(obj):
            out.update(_graph_tensors(getattr(obj, f.name),
                                      f"{prefix}.{f.name}"))
        return out
    if isinstance(obj, (tuple, list)):
        out = {}
        for i, x in enumerate(obj):
            out.update(_graph_tensors(x, f"{prefix}[{i}]"))
        return out
    return {prefix: obj}


def _assert_same_graph(label: str, got, want) -> None:
    """Every plan's indices and flags, every tile and every scalar equal."""
    a, b = _graph_tensors(got), _graph_tensors(want)
    if a.keys() != b.keys():
        raise AssertionError(f"{label}: graph fields differ")
    for k in a:
        same = (a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])
                if isinstance(a[k], torch.Tensor) else a[k] == b[k])
        if not same:
            raise AssertionError(f"{label}: {k} differs from the fresh graph")
    print(f"  {label}: all {len(a)} fields equal the fresh graph's")


def phase_persistence(ls, rg, scm, fresh: dict, router_s: float,
                      smi: str) -> dict:
    """Save the phase-4 graph, load it on the card (full and slim), and run
    PageRank and one DO-BFS root on the loaded graph; returns the kernels'
    launch counts on this path."""
    from vectorgraphlibrary_tpu_torch.graph.persistence import (
        load_graph_from_binary_file, save_graph_to_binary_file)
    from vectorgraphlibrary_tpu_torch.graph.vertices import as_original_numpy
    from vectorgraphlibrary_tpu_torch.models import bfs, common, pr
    from vectorgraphlibrary_tpu_torch.utils.verify import verify_ranking_results

    graph, ec = fresh["graph"], fresh["ec"]
    src = common.select_random_source(ec, seed=100)
    want_levels = bfs.vgl_bfs_device(graph, src).values
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, f"rmat{SCALE}.npz")
        t0 = time.perf_counter()
        save_graph_to_binary_file(graph, path, compressed=False)
        save_s = time.perf_counter() - t0
        print(f"  save: {save_s:.2f} s (the Beneš router alone took "
              f"{router_s:.2f} s on the advance route in phase 7), file "
              f"{os.path.getsize(path) / 2**20:.1f} MiB")

        ls.lane_shuffle.launches = 0
        rg.route_gather_finish.launches = 0
        scm.scatter_combine.launches = 0
        t0 = time.perf_counter()
        g = load_graph_from_binary_file(path, device=DEVICE)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        n_ls = ls.lane_shuffle.launches
        ranks, _ = pr.vgl_page_rank(g, max_iterations=ITERS,
                                    use_convergence=False)
        lv = bfs.vgl_bfs_device(g, src).values
        torch.cuda.synchronize()
        counts = dict(lane_shuffle=n_ls,
                      route_gather_finish=rg.route_gather_finish.launches,
                      scatter_combine=scm.scatter_combine.launches)
        print(f"  load on {DEVICE}: {load_s:.2f} s; launches on this path "
              f"(load, vgl_page_rank, one DO-BFS root): {counts}")
        if n_ls != 8:
            raise AssertionError(f"load launched lane_shuffle {n_ls} times, "
                                 "expected 8 (two per plan)")
        if not all(counts.values()):
            raise AssertionError(f"a kernel of this path did not launch: "
                                 f"{counts}")
        _assert_same_graph("loaded graph", g, graph)

        vals = ranks.values
        if fresh["deterministic"]:
            same = torch.equal(vals, fresh["ranks"])
            print(f"  PageRank on the loaded graph: "
                  f"{'bit-identical to' if same else 'DIFFERS from'} phase 4")
        else:          # the card's runs on one graph already differ
            same = torch.allclose(vals, fresh["ranks"], rtol=1e-5, atol=1e-8)
            print(f"  PageRank on the loaded graph: within rtol 1e-5 of "
                  f"phase 4: {same}")
        if not same:
            raise AssertionError("PageRank on the loaded graph differs")
        errors = verify_ranking_results(as_original_numpy(ranks, g),
                                        fresh["oracle"])
        if errors:
            raise AssertionError(f"PageRank on the loaded graph: error count "
                                 f"{errors}")
        if not torch.equal(lv, want_levels):
            raise AssertionError(f"DO-BFS root {src} on the loaded graph "
                                 "differs from the fresh graph's levels")
        print(f"  DO-BFS root {src} on the loaded graph: levels equal")

        slim = os.path.join(d, f"rmat{SCALE}_slim.npz")
        with np.load(path) as z:
            np.savez(slim, **{k: z[k] for k in z.files if k.rsplit(".", 1)[-1]
                              not in ("in_masks", "out_masks", "lane_idx")})
        os.remove(path)
        ls.lane_shuffle.launches = 0
        t0 = time.perf_counter()
        g = load_graph_from_binary_file(slim, device=DEVICE)
        torch.cuda.synchronize()
        print(f"  slim load (word masks only, "
              f"{os.path.getsize(slim) / 2**20:.1f} MiB): "
              f"{time.perf_counter() - t0:.2f} s, lane_shuffle launches "
              f"{ls.lane_shuffle.launches}")
        if ls.lane_shuffle.launches != 8:
            raise AssertionError("slim load: expected 8 lane_shuffle launches")
        _assert_same_graph("slim-loaded graph", g, graph)
    return counts


def profile(pr_graph, bfs_graph, bfs_root, out_dir: str) -> None:
    from torch.profiler import ProfilerActivity, profile as tprofile
    from vectorgraphlibrary_tpu_torch.models import bfs, pr
    os.makedirs(out_dir, exist_ok=True)
    runs = (("pr_profile.txt", lambda: pr.vgl_page_rank(
                pr_graph, max_iterations=10, use_convergence=False)),
            ("bfs_do_profile.txt",
             lambda: bfs.vgl_bfs_device(bfs_graph, bfs_root)))
    for fname, fn in runs:
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        table = prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=30)
        with open(os.path.join(out_dir, fname), "w") as f:
            f.write(table)
        print(fname)
        print("\n".join(table.splitlines()[:24]))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.manual_seed(SEED)
    from vectorgraphlibrary_tpu_torch.ops.cuda import build
    from vectorgraphlibrary_tpu_torch.ops.cuda import lane_shuffle as ls
    from vectorgraphlibrary_tpu_torch.ops.cuda import route_gather as rg
    from vectorgraphlibrary_tpu_torch.ops.cuda import scatter_combine as scm

    name = torch.cuda.get_device_name(0)
    smi = _smi()
    print(f"[1/8] device: {name} ({torch.cuda.device_count()} visible); "
          f"nvidia-smi: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")

    t0 = time.perf_counter()
    build.load_library()
    ptxas = [ln.strip() for ln in build.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[2/8] build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{build.build_seconds:.2f} s, one process per source, sm_90a); "
          f"ptxas: " + " | ".join(ptxas))

    print("[3/8] kernel: route_gather_finish vs plain version, n = 2^24")
    max_err, rand_ms, rand_plain_ms = phase_kernel(rg)

    print(f"[4/8] slice: PageRank on RMAT-{SCALE}")
    prr = phase_pagerank(rg, smi)
    max_err = max(max_err, prr["max_err"])

    print("[5/8] kernel: scatter_combine vs plain version, V = 2^20")
    sc = phase_scatter(scm, smi)

    print(f"[6/8] slice: BFS on RMAT-{BFS_SCALE}")
    bfs_graph, bfs_root, sc_launches, rg_bfs = phase_bfs(rg, scm, smi)

    print(f"[7/8] kernel: lane_shuffle vs plain version, "
          f"[{prr['graph'].advance_route.n // 128}, 128]")
    lsr = phase_lane_shuffle(ls, prr["graph"], smi)

    print(f"[8/8] slice: save and load RMAT-{SCALE}, then PageRank and BFS "
          f"on the loaded graph")
    loaded = phase_persistence(ls, rg, scm, prr, lsr["router_s"], smi)

    if "--profile" in sys.argv:
        profile(prr["graph"], bfs_graph, bfs_root,
                sys.argv[sys.argv.index("--profile") + 1])

    def times(r: dict) -> dict:
        return {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
    rg_paths = {f"pagerank_rmat{SCALE}": prr["launches"],
                f"bfs_do_rmat{BFS_SCALE}": rg_bfs,
                f"loaded_rmat{SCALE}": loaded["route_gather_finish"]}
    sc_paths = {f"bfs_do_rmat{BFS_SCALE}": sc_launches,
                f"loaded_rmat{SCALE}": loaded["scatter_combine"]}
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "route_gather_finish", "route": "cuda",
        "source": "vectorgraphlibrary_tpu_torch/csrc/route_gather.cu",
        "replaces": REPLACES, "launches": sum(rg_paths.values()),
        "launches_by_path": rg_paths, "max_abs_err": max_err, **times(prr),
        "bound_by": "bytes", "random_perm_2p24_ms": rand_ms,
        "random_perm_2p24_plain_ms": rand_plain_ms}, {
        "name": "scatter_combine", "route": "cuda",
        "source": "vectorgraphlibrary_tpu_torch/csrc/scatter_combine.cu",
        "replaces": REPLACES_SCATTER, "launches": sum(sc_paths.values()),
        "launches_by_path": sc_paths, "max_abs_err": sc["max_err"],
        **times(sc), "bound_by": "bytes"}, {
        "name": "lane_shuffle", "route": "cuda",
        "source": "vectorgraphlibrary_tpu_torch/csrc/lane_shuffle.cu",
        "replaces": REPLACES_LANE, "launches": loaded["lane_shuffle"],
        "launches_by_path": {f"loaded_rmat{SCALE}": loaded["lane_shuffle"]},
        "max_abs_err": lsr["max_err"], **times(lsr), "bound_by": "bytes"}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
