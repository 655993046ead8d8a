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
   rows checked); per-root DO GTEPS and MS-BFS aggregate GTEPS, medians of 3.

The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}. --profile DIR also writes torch.profiler
tables of one 10-iteration PageRank run and one DO-BFS root to DIR (not part
of the default run).
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
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
        pr.vgl_page_rank(graph, max_iterations=ITERS, use_convergence=False)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
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
    print(f"  RMAT-{SCALE} advance route f32 fwd finish: kernel {k_ms:.4f} ms "
          f"(runs {', '.join(f'{t:.4f}' for t in ks)}), plain {p_ms:.4f} ms "
          f"(runs {', '.join(f'{t:.4f}' for t in ps)})")
    return graph, launches, max_err, k_ms, p_ms


def _median3(label: str, unit: str, values, smi: str) -> float:
    v = sorted(values)
    print(f"  {label}: median {v[1]:.4f} {unit} (min {v[0]:.4f}, max "
          f"{v[2]:.4f}) on {smi}")
    return v[1]


def phase_scatter(scm, smi: str) -> tuple[float, float, float]:
    """scatter_combine against its plain version at the BFS push's shapes
    (V = 2^20 vertices); returns (max_abs_err, ms, plain_ms) of the BFS
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
    res = exp_push.measure(DEVICE)
    print("  exp_push (ms per scatter of message 1 into 2^20): "
          + ", ".join(f"{k} {t:.4f}" for k, t in res.items()))
    return max_err, k_ms, p_ms


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
    from vectorgraphlibrary_tpu_torch.ops.cuda import route_gather as rg
    from vectorgraphlibrary_tpu_torch.ops.cuda import scatter_combine as scm

    name = torch.cuda.get_device_name(0)
    smi = _smi()
    print(f"[1/6] device: {name} ({torch.cuda.device_count()} visible); "
          f"nvidia-smi: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")

    t0 = time.perf_counter()
    build.load_library()
    ptxas = [ln.strip() for ln in build.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[2/6] build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{build.build_seconds:.2f} s, sm_90a); ptxas: "
          + " | ".join(ptxas))

    print("[3/6] kernel: route_gather_finish vs plain version, n = 2^24")
    max_err, rand_ms, rand_plain_ms = phase_kernel(rg)

    print(f"[4/6] slice: PageRank on RMAT-{SCALE}")
    graph, launches, slice_err, k_ms, p_ms = phase_pagerank(rg, smi)
    max_err = max(max_err, slice_err)

    print("[5/6] kernel: scatter_combine vs plain version, V = 2^20")
    sc_err, sc_ms, sc_plain_ms = phase_scatter(scm, smi)

    print(f"[6/6] slice: BFS on RMAT-{BFS_SCALE}")
    bfs_graph, bfs_root, sc_launches, rg_bfs = phase_bfs(rg, scm, smi)

    if "--profile" in sys.argv:
        profile(graph, bfs_graph, bfs_root,
                sys.argv[sys.argv.index("--profile") + 1])

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "route_gather_finish", "route": "cuda",
        "source": "vectorgraphlibrary_tpu_torch/csrc/route_gather.cu",
        "replaces": REPLACES, "launches": launches + rg_bfs,
        "launches_by_path": {f"pagerank_rmat{SCALE}": launches,
                             f"bfs_do_rmat{BFS_SCALE}": rg_bfs},
        "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
        "random_perm_2p24_ms": rand_ms, "random_perm_2p24_plain_ms":
            rand_plain_ms}, {
        "name": "scatter_combine", "route": "cuda",
        "source": "vectorgraphlibrary_tpu_torch/csrc/scatter_combine.cu",
        "replaces": REPLACES_SCATTER, "launches": sc_launches,
        "launches_by_path": {f"bfs_do_rmat{BFS_SCALE}": sc_launches},
        "max_abs_err": sc_err, "ms": sc_ms, "plain_ms": sc_plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
