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
   vgl_page_rank call must launch pull_reduce exactly 100 times and
   route_gather_finish once (the out-degrees' vertex route), two runs must
   give the same bits, and the MTEPS (|E| * 100 / time) of three more runs
   are printed. Then pull_reduce against its plain version on that graph
   (f32 add within rtol 1e-5 / atol 1e-6, every other case exactly: f32
   add without self-loops and min over GATHER, add and max over SCATTER,
   i32 min, max and or, int8 any01), its time beside the plain version's
   and torch.mv of the CSR tensor; the route kernel on the graph's routes,
   timed on the vertex route the path runs and on the 2^24 advance route;
5. kernel: scatter_combine against its plain version on the card, bit for
   bit, into V = 2^20 int32 vertices from 2^15, 2^16 and 2^17 destinations
   (an eighth of them dropped), all dropped, and none; min and max of random
   int32 messages and or of message 1; kernel and plain times, device times
   by torch.profiler, and the three variants of apps/exp_push.py. Then
   push_expand against its plain version, bit for bit, on the RMAT-20
   graph's outgoing CSR: frontiers of about 2^15, 2^16 and 2^17 edges, 2^16
   edges into a capacity of 2^15, zero-degree and invalid entries, and an
   empty frontier, each with min, max and or; kernel and plain times;
6. slice: BFS on RMAT-20 (average degree 16, seed 42; the graph is generated
   weighted once, for phases 9 and 10, and BFS reads no weights) through
   import_graph and the BFS entry points: vgl_bfs_device on 8 roots (each
   with error count 0 against seq_top_down, and per root push_expand
   launched once per top-down level, pull_reduce once per bottom-up level,
   route_gather_finish twice per bottom-up level and scatter_combine never),
   vgl_top_down and vgl_bfs (-bu) on one root, vgl_msbfs on 64 roots (4 rows
   checked); pull_reduce against its plain version at the bottom-up shape
   (int8 any01 over GATHER) and on int32 words, timed; per-root DO GTEPS and
   MS-BFS aggregate GTEPS, medians of 3;
7. kernel: lane_shuffle against its plain version on the card, bit for bit,
   at [2^17, 128] (n = 2^24): random per-row permutations of f32, i32 and
   int8 values, and the forward and inverse lane indices of the phase-4
   RMAT-18 advance route from the port's Beneš router (timed); kernel, plain
   and torch.gather times;
8. slice: persistence on the phase-4 RMAT-18 graph: save (uncompressed, to a
   temporary directory), load on the card (exactly 8 lane_shuffle launches:
   two per plan), every plan's indices and flags and every tile equal to the
   phase-4 graph's; vgl_page_rank (100 iterations) on the loaded graph equal
   to the phase-4 ranks bit for bit and error count 0 against
   seq_page_rank; one vgl_bfs_device root equal to the phase-4 graph's
   levels; the same load from a slim copy of the file (word masks only, as
   a TPU host saves it).

9. kernel: pull_reduce with edge weights against its plain version on the
   weighted RMAT-20 graph's CSRs (f32 min of x + w and max of min(x, w) over
   GATHER, exactly; i32 min and f32 add over both directions, add within
   rtol 1e-5 / atol 1e-6), with kernel and plain times, bounds and torch.mv
   of the CSR tensor for the f32 add; scatter_combine f32 min and max
   against its plain version, bit for bit (dropped, duplicate and inf
   entries), timed at the largest push capacity a partial SSSP run takes,
   beside scatter_reduce; and what one launch through ctypes costs on the
   host (the smallest route_gather_finish call by events and by
   torch.profiler, beside index_select);
10. slice: the fixpoint family on the weighted RMAT-20 graph, sources as
   bench.py picks them: vgl_dijkstra_all_active and
   vgl_dijkstra_partial_device on 2 sources (equal bit for bit, error count
   0 against seq_dijkstra; one pull_reduce per all-active sweep and per
   dense sweep, two scatter_combine and three route_gather_finish per
   sparse sweep), vgl_widest_paths on 1 source, vgl_shiloach_vishkin (two
   pull_reduce and four route_gather_finish per iteration) and
   vgl_cc_hybrid (equal_components 0 against seq_cc), vgl_hits with 20
   iterations (40 pull_reduce, 42 route_gather_finish;
   verify_ranking_results 0 against seq_hits), and MTEPS by bench.py's
   formulas, medians of 3.

The line before the last is {"kernels": [...]}: for each kernel its launches
on each path, its error against the plain version, and its time, its plain
version's time, the one-call PyTorch time (library_ms, null where there is
none) and its bound (bound_ms: the bytes it must move at the H100's 3.35
TB/s) at the main path's shapes. The last line is {"ok": true, "device":
{...}}. --profile DIR also writes torch.profiler tables of one 10-iteration
PageRank run, one DO-BFS root, one all-active SSSP run and one HITS call to
DIR (not part of the default run).
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


def _pull_check(pl, label: str, dg, x, op: str, excl: bool, weights=None,
                weight_op=None) -> float:
    """pull_reduce against its plain version on the same inputs, with the
    graph's work units: f32 sums at rtol 1e-5 / atol 1e-6 (the plain version
    sums each row in another order), everything else exactly. Returns the
    max abs error."""
    from vectorgraphlibrary_tpu_torch.ops.advance import row_groups
    kw = dict(weights=weights, weight_op=weight_op)
    got = pl.pull_reduce(dg.row_ptr, dg.col_idx, x, op, excl, row_groups(dg),
                         **kw)
    want = pl.pull_reduce_ref(dg.row_ptr, dg.col_idx, x, op, excl, **kw)
    torch.cuda.synchronize()
    # equal entries (identities of empty rows, inf or not) count as 0
    err = torch.where(got == want, 0.0, (got.double() - want.double()).abs()) \
        .max().item()
    if op == "add" and x.dtype == torch.float32:
        ok = bool(torch.isclose(got, want, rtol=1e-5, atol=1e-6).all())
        how = "within rtol 1e-5, atol 1e-6"
    else:
        ok = torch.equal(got, want)
        how = "exact"
    print(f"  pull_reduce {label}: {how if ok else 'MISMATCH'} (max abs err "
          f"{err})")
    if not ok:
        raise AssertionError(f"pull_reduce != plain version: {label}")
    return err


def _pull_times(pl, dg, x, op: str, excl: bool, label: str, smi: str,
                weights=None, weight_op=None) -> dict:
    """Kernel and plain version on the same pull, medians of 3, each the mean
    of 10 launches."""
    from vectorgraphlibrary_tpu_torch.ops.advance import row_groups
    groups = row_groups(dg)
    kw = dict(weights=weights, weight_op=weight_op)
    k_ms = _median3(f"pull_reduce {label}, kernel", "ms",
                    [_cuda_ms(lambda: pl.pull_reduce(
                        dg.row_ptr, dg.col_idx, x, op, excl, groups, **kw))
                     for _ in range(3)], smi)
    p_ms = _median3(f"pull_reduce {label}, plain", "ms",
                    [_cuda_ms(lambda: pl.pull_reduce_ref(
                        dg.row_ptr, dg.col_idx, x, op, excl, **kw))
                     for _ in range(3)], smi)
    # bytes it must move: row_ptr, col_idx (and the weights) of the real
    # edges, x, out
    per_edge = 4 if weights is None else 4 + weights.element_size()
    bound = _bound_ms((dg.v_pad + 1) * 4 + dg.e * per_edge
                      + 2 * dg.v_pad * x.element_size())
    print(f"  pull_reduce {label} bound {bound:.4f} ms (groups {groups})")
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound)


def phase_pagerank(rg, pl, smi: str):
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
    pl.pull_reduce.launches = 0
    t0 = time.perf_counter()
    ranks, iters = pr.vgl_page_rank(graph, max_iterations=ITERS,
                                    use_convergence=False)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(pull_reduce=pl.pull_reduce.launches,
                    route_gather_finish=rg.route_gather_finish.launches)
    peak = torch.cuda.max_memory_allocated()
    print(f"  vgl_page_rank: {iters} iterations, launches {launches}, first "
          f"run {first_s:.4f} s, peak device memory {peak / 2**20:.1f} MiB")
    if launches != dict(pull_reduce=ITERS, route_gather_finish=1):
        raise AssertionError(f"expected {ITERS} pull_reduce launches and 1 "
                             f"route_gather_finish launch, got {launches}")
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
    if not deterministic:
        raise AssertionError("two vgl_page_rank runs on one graph differ")
    rates = sorted(ec.edges_count * ITERS / t / 1e6 for t in times)
    print(f"  PR RMAT-{SCALE} MTEPS median {rates[1]:.1f} (min {rates[0]:.1f}, "
          f"max {rates[2]:.1f}; runs {', '.join(f'{t:.4f}' for t in times)} s) "
          f"on {smi}")

    # the pull kernel against its plain version on this graph: the path's
    # own pull (f32 add without self-loops over GATHER), then the other
    # directions, monoids and types it takes
    from vectorgraphlibrary_tpu_torch.models.bfs import G, S
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    v_pad = graph.v_pad
    xf = torch.rand(v_pad, device=DEVICE, generator=gen)
    xi = torch.randint(-2**31, 2**31 - 1, (v_pad,), device=DEVICE,
                       generator=gen, dtype=torch.int32)
    xb = torch.randint(0, 2, (v_pad,), device=DEVICE, generator=gen,
                       dtype=torch.int8)
    g_in, g_out = graph.direction(G), graph.direction(S)
    pull_err = max(
        _pull_check(pl, f"RMAT-{SCALE} G f32 add excl", g_in, xf, "add", True),
        _pull_check(pl, f"RMAT-{SCALE} S f32 add", g_out, xf, "add", False),
        _pull_check(pl, f"RMAT-{SCALE} G f32 min", g_in, xf, "min", False),
        _pull_check(pl, f"RMAT-{SCALE} S f32 max excl", g_out, xf, "max",
                    True),
        _pull_check(pl, f"RMAT-{SCALE} G i32 min", g_in, xi, "min", False),
        _pull_check(pl, f"RMAT-{SCALE} S i32 max excl", g_out, xi, "max",
                    True),
        _pull_check(pl, f"RMAT-{SCALE} G i32 or", g_in, xi, "or", False),
        _pull_check(pl, f"RMAT-{SCALE} G i8 any01", g_in, xb, "any01", False),
        _pull_check(pl, f"RMAT-{SCALE} S i8 any01 excl", g_out, xb, "any01",
                    True))
    pull = _pull_times(pl, g_in, xf, "add", True,
                       f"RMAT-{SCALE} G f32 add excl", smi)
    # one-call PyTorch: cuSPARSE SpMV of the CSR with 1.0 per edge and 0.0
    # on self-loops (the same function up to the order of the sums)
    e = g_in.e
    rows = torch.repeat_interleave(
        torch.arange(v_pad, device=DEVICE, dtype=torch.int32),
        g_in.degrees.long(), output_size=e)
    cols = g_in.col_idx[:e]
    a = torch.sparse_csr_tensor(g_in.row_ptr, cols, (cols != rows).float(),
                                size=(v_pad, v_pad))
    lib = _median3(f"pull_reduce RMAT-{SCALE} G f32 add excl, torch.mv of a "
                   f"CSR tensor", "ms",
                   [_cuda_ms(lambda: torch.mv(a, xf)) for _ in range(3)], smi)
    spmv_err = (torch.mv(a, xf) - pl.pull_reduce_ref(
        g_in.row_ptr, g_in.col_idx, xf, "add", True)).abs().max().item()
    print(f"  torch.mv against the plain pull: max abs err {spmv_err}")
    pull.update(max_err=pull_err, library_ms=lib)

    # the route kernel on the path: the inverse vertex route on int32
    # out-degrees (the one launch per vgl_page_rank), against its plain
    # version with the other routes of this graph
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
    degs = graph.outgoing.degrees
    k_ms = _median3(f"route_gather_finish RMAT-{SCALE} vertex route i32 inv, "
                    f"kernel", "ms", [_cuda_ms(lambda: rg.route_gather_finish(
                        degs, vplan.inv_idx)) for _ in range(3)], smi)
    p_ms = _median3(f"route_gather_finish RMAT-{SCALE} vertex route i32 inv, "
                    f"plain", "ms", [_cuda_ms(lambda: rg.route_gather_finish_ref(
                        degs, vplan.inv_idx)) for _ in range(3)], smi)
    lib_ms = _median3(f"route_gather_finish RMAT-{SCALE} vertex route i32 inv, "
                      f"index_select", "ms", [_cuda_ms(lambda: torch.index_select(
                          degs, 0, vplan.inv_idx)) for _ in range(3)], smi)
    bound = _bound_ms(vplan.n * (4 + 4 + 4))      # idx, x, out
    print(f"  route_gather_finish vertex route bound {bound:.4f} ms")
    # device time alone (torch.profiler): the event times above are the
    # host's cost of issuing one launch
    dev_k = _profiled_ms(lambda: rg.route_gather_finish(degs, vplan.inv_idx))
    dev_l = _profiled_ms(lambda: torch.index_select(degs, 0, vplan.inv_idx))
    print(f"  route_gather_finish vertex route, device ms per call by "
          f"torch.profiler: {dev_k['total']:.4f}; index_select: "
          f"{dev_l['total']:.4f}")
    # the advance route with the PR finish, as PRs 1-3 timed it
    ks, ps = [], []
    for _ in range(3):
        ks.append(_cuda_ms(lambda: apply_route(plan, msgs, finish=fin)))
        ps.append(_cuda_ms(lambda: rg.route_gather_finish_ref(
            msgs, plan.fwd_idx, flags=plan.flags_fwd, exclude_self_loops=True,
            ident=0.0)))
    adv_ms, adv_plain_ms = statistics.median(ks), statistics.median(ps)
    f = plan.flags_fwd
    kept = int(((f & 1 != 0) & (f & 2 == 0)).sum())
    adv_bound = _bound_ms(plan.n * (1 + 4) + kept * (4 + 4))
    print(f"  RMAT-{SCALE} advance route f32 fwd finish (no longer on the "
          f"path): kernel {adv_ms:.4f} ms (runs "
          f"{', '.join(f'{t:.4f}' for t in ks)}), plain {adv_plain_ms:.4f} ms, "
          f"bound {adv_bound:.4f} ms on {smi}")
    route = dict(max_err=max_err, ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                 bound_ms=bound, device_ms=dev_k["total"],
                 library_device_ms=dev_l["total"], advance_route_2p24_ms=adv_ms,
                 advance_route_2p24_plain_ms=adv_plain_ms,
                 advance_route_2p24_bound_ms=adv_bound)
    return dict(graph=graph, ec=ec, ranks=vals, oracle=want,
                launches=launches, route=route, pull=pull)


def _median3(label: str, unit: str, values, smi: str) -> float:
    v = sorted(values)
    print(f"  {label}: median {v[1]:.4f} {unit} (min {v[0]:.4f}, max "
          f"{v[2]:.4f}) on {smi}")
    return v[1]


def _device_events(fn, reps: int = 1) -> list:
    """The device events (kernels, copies) of `reps` calls of fn, by
    torch.profiler. The profiler loses the first kernels after it starts,
    while its activity buffers are set up, so fn runs once inside it first
    and only the events after a marker count. Now and then a window comes
    back without any device event: it is taken again, three times at most."""
    from torch.autograd import DeviceType
    from torch.profiler import (ProfilerActivity, profile as tprofile,
                                record_function)
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            with record_function("vgl_measured"):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
        events = prof.events()
        mark = min(e.time_range.start for e in events
                   if e.name == "vgl_measured"
                   and e.device_type == DeviceType.CPU)
        dev = [e for e in events if e.device_type == DeviceType.CUDA
               and e.name != "vgl_measured" and e.time_range.start >= mark]
        if dev:
            return dev
    raise RuntimeError("torch.profiler recorded no device event in 3 windows")


def _profiled_ms(fn, reps: int = 10) -> dict:
    """Device time per call by torch.profiler over `reps` calls, in ms: each
    device event's name (kernels, copies) with its total, and "total"."""
    by_name: dict = {}
    for e in _device_events(fn, reps):
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + e.time_range.elapsed_us() / reps / 1e3)
    by_name["total"] = sum(by_name.values())
    return by_name


def _frontier(graph, rng, edges: int, zero_degree: int = 0):
    """A compacted SCATTER-ordered frontier of random vertices whose
    out-degrees sum to about `edges`, plus `zero_degree` vertices of degree
    0; its capacity is twice the next power of two of its size, so it has
    invalid entries too. Returns (ids, valid, degree sum)."""
    from vectorgraphlibrary_tpu_torch.graph import frontier
    from vectorgraphlibrary_tpu_torch.models import bfs, common
    degs = graph.outgoing.degrees.cpu().numpy()[:graph.v]
    mask = np.zeros(graph.v_pad, bool)
    if edges:
        # rows below the huge class, so the sum lands near `edges`
        order = rng.permutation(np.flatnonzero((degs > 0) & (degs <= 256)))
        mask[order[:int(np.searchsorted(np.cumsum(degs[order]), edges)) + 1]] \
            = True
    mask[np.flatnonzero(degs == 0)[:zero_degree]] = True
    fr = frontier.from_mask(graph, torch.from_numpy(mask).to(DEVICE), bfs.S)
    size = int(fr.size)
    ids, valid = frontier.compact_ids(fr, 2 * common.next_pow2(max(size, 8)))
    return ids, valid, int(fr.neighbours_count)


def phase_scatter(scm, pe, graph, smi: str) -> dict:
    """scatter_combine against its plain version at the BFS push's shapes
    (V = 2^20 vertices), and push_expand against its plain version on the
    RMAT-20 graph's outgoing CSR; returns both kernels' errors and times (the
    BFS combine, min, at the largest default tier, 2^16 edges)."""
    from vectorgraphlibrary_tpu_torch.apps import exp_push
    from vectorgraphlibrary_tpu_torch.models.common import next_pow2
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
    # device time alone (torch.profiler): the kernel, the copy of the target
    # it returns, and the library call's kernels
    dev_k = _profiled_ms(lambda: scm.scatter_combine(out, idx, msg, "min"))
    dev_l = _profiled_ms(lambda: torch.scatter_reduce(out, 0, idx_in, msg_in,
                                                      "amin"))
    print(f"  scatter_combine min 2^16 -> 2^20, device ms per call by "
          f"torch.profiler: {json.dumps(dev_k)}; scatter_reduce: "
          f"{json.dumps(dev_l)}")
    # bytes it must move: out read and the copy written (4 B each per
    # vertex), every index, the messages that land
    bound = _bound_ms(8 * v + 4 * idx.shape[0] + 4 * idx_in.shape[0])
    print(f"  scatter_combine bound {bound:.4f} ms")
    # the apps/exp_push.py path, the app that times the TPU kernel's port
    scm.scatter_combine.launches = 0
    res = exp_push.measure(DEVICE)
    torch.cuda.synchronize()
    exp_launches = scm.scatter_combine.launches
    print("  exp_push (ms per scatter of message 1 into 2^20): "
          + ", ".join(f"{k} {t:.4f}" for k, t in res.items())
          + f"; scatter_combine launches {exp_launches}")
    if not exp_launches:
        raise AssertionError("exp_push did not launch scatter_combine")
    sc = dict(max_err=max_err, ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
              bound_ms=bound, device_ms=dev_k["total"],
              library_device_ms=dev_l["total"], launches=exp_launches)

    # push_expand on the RMAT-20 graph's outgoing CSR, bit for bit
    dg = graph.outgoing
    target = torch.full((graph.v_pad,), 2**31 - 1, dtype=torch.int32,
                        device=dev)
    target[::3] = 2
    frontiers = [(f"~2^{lg} edges", _frontier(graph, rng, 1 << lg), 0)
                 for lg in (15, 16, 17)]
    frontiers.append(("~2^16 edges past a capacity of half",
                      _frontier(graph, rng, 1 << 16), 1 << 15))
    frontiers.append(("zero-degree and invalid entries",
                      _frontier(graph, rng, 1 << 12, zero_degree=500), 0))
    frontiers.append(("empty", _frontier(graph, rng, 0), 64))
    pe_err = 0.0
    for label, (ids, valid, nbrs), ecap in frontiers:
        ecap = ecap or next_pow2(nbrs)
        for op, m, base in (("min", 5, target), ("max", 7, out[:graph.v_pad]),
                            ("or", 1 << 9, out[:graph.v_pad])):
            got = pe.push_expand(base, dg.row_ptr, dg.col_idx, dg.degrees, ids,
                                 valid, ecap, m, op)
            want = pe.push_expand_ref(base, dg.row_ptr, dg.col_idx, dg.degrees,
                                      ids, valid, ecap, m, op)
            torch.cuda.synchronize()
            err = (got.double() - want.double()).abs().max().item()
            ok = torch.equal(got, want)
            print(f"  push_expand {label} ({int(valid.sum())} entries of "
                  f"{ids.shape[0]}, {nbrs} edges, capacity {ecap}) {op}: "
                  f"{'bit-exact' if ok else 'MISMATCH'} (max abs err {err})")
            if not ok:
                raise AssertionError(f"push_expand != plain version: {label} "
                                     f"{op}")
            pe_err = max(pe_err, err)
    ids, valid, nbrs = frontiers[1][1]
    ecap = next_pow2(nbrs)
    args = (target, dg.row_ptr, dg.col_idx, dg.degrees, ids, valid, ecap, 5,
            "min")
    pk = _median3(f"push_expand min {nbrs} edges -> 2^20, kernel", "ms",
                  [_cuda_ms(lambda: pe.push_expand(*args)) for _ in range(3)],
                  smi)
    pp = _median3(f"push_expand min {nbrs} edges -> 2^20, plain", "ms",
                  [_cuda_ms(lambda: pe.push_expand_ref(*args))
                   for _ in range(3)], smi)
    dev_p = _profiled_ms(lambda: pe.push_expand(*args))
    print(f"  push_expand device ms per call by torch.profiler: "
          f"{json.dumps(dev_p)}")
    # bytes it must move: the target read and its copy written, ids, ends
    # and row starts of the frontier's entries, col_idx of every edge
    p_bound = _bound_ms(8 * graph.v_pad + 12 * ids.shape[0]
                        + 4 * min(nbrs, ecap))
    print(f"  push_expand bound {p_bound:.4f} ms")
    push = dict(max_err=pe_err, ms=pk, plain_ms=pp, library_ms=None,
                bound_ms=p_bound, device_ms=dev_p["total"])
    return dict(scatter=sc, push=push)


def make_bfs_graph():
    """The scale-20 family's one shared import: weighted RMAT-20 (BFS reads
    no weights) and its EdgeArray."""
    from vectorgraphlibrary_tpu_torch.graph.device import import_graph
    from vectorgraphlibrary_tpu_torch.graph.edges import (
        build_edge_array_from_host)
    from vectorgraphlibrary_tpu_torch.io import generation
    t0 = time.perf_counter()
    ec = generation.rmat(BFS_SCALE, BFS_DEGREE, seed=SEED, weighted=True)
    t1 = time.perf_counter()
    host = []
    graph = import_graph(ec, device=DEVICE, _host_out=host)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ea = build_edge_array_from_host(ec.weights, graph, host[0], host[1])
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    print(f"  RMAT-{BFS_SCALE}: |V|={graph.v} |E|={graph.e}, generate "
          f"{t1 - t0:.2f} s, import {t2 - t1:.2f} s, edge weights "
          f"{t3 - t2:.2f} s")
    return ec, graph, ea


def phase_bfs(rg, pl, pe, scm, ec, graph, smi: str):
    """BFS on RMAT-20 through the port's entry points; returns the kernels'
    launch counts over the 8 vgl_bfs_device calls and the pull's check and
    times at the bottom-up shape (int8 any01 over GATHER)."""
    from vectorgraphlibrary_tpu_torch.graph.vertices import (VertexArray,
                                                             as_original_numpy)
    from vectorgraphlibrary_tpu_torch.models import bfs, common
    from vectorgraphlibrary_tpu_torch.utils.verify import verify_results

    def check(label, values, src):
        if values.shape != (graph.v_pad,) or values.dtype != torch.int32:
            raise AssertionError(f"{label}: levels are not int32 [v_pad]")
        got = as_original_numpy(VertexArray(values=values, direction=bfs.S),
                                graph)
        errors = verify_results(got, bfs.seq_top_down(ec, src))
        if errors:
            raise AssertionError(f"{label} root {src}: error count {errors}")

    kernels = dict(push_expand=pe.push_expand, pull_reduce=pl.pull_reduce,
                   route_gather_finish=rg.route_gather_finish,
                   scatter_combine=scm.scatter_combine)
    roots = [common.select_random_source(ec, seed=100 + s)
             for s in range(BFS_ROOTS)]
    torch.cuda.reset_peak_memory_stats()
    totals = dict.fromkeys(kernels, 0)
    for src in roots:
        trace = []
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        lv = bfs.vgl_bfs_device(graph, src, trace=trace)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = {name: k.launches for name, k in kernels.items()}
        td = sum(t[0] == "td" for t in trace)
        bu = len(trace) - td
        print(f"  vgl_bfs_device root {src}: {len(trace)} levels ({td} "
              f"top-down, {bu} bottom-up), launches {n}, {dt:.4f} s")
        # one push per top-down level; one pull per bottom-up level, whose
        # S-ordered levels take a vertex route in and one back out
        want = dict(push_expand=td, pull_reduce=bu,
                    route_gather_finish=2 * bu, scatter_combine=0)
        if n != want:
            raise AssertionError(f"launches {n}, expected {want}")
        for name in totals:
            totals[name] += n[name]
        check("vgl_bfs_device", lv.values, src)
    if not (totals["push_expand"] and totals["pull_reduce"]):
        raise AssertionError("the DO-BFS run did not launch both kernels")
    for k in kernels.values():
        k.launches = 0
    check("vgl_top_down", bfs.vgl_top_down(graph, roots[0]).values, roots[0])
    check("vgl_bfs -bu", bfs.vgl_bfs(graph, roots[0], alpha=1e-9).values,
          roots[0])
    print(f"  vgl_top_down and vgl_bfs -bu, root {roots[0]}: launches "
          f"{ {name: k.launches for name, k in kernels.items()} }")

    ms_roots = [common.select_random_source(ec, seed=500 + s)
                for s in range(MS_ROOTS)]
    for k in kernels.values():
        k.launches = 0
    lv_ms = bfs.vgl_msbfs(graph, ms_roots).values
    torch.cuda.synchronize()
    print(f"  vgl_msbfs {MS_ROOTS} roots: launches "
          f"{ {name: k.launches for name, k in kernels.items()} }")
    if lv_ms.shape != (MS_ROOTS, graph.v_pad):
        raise AssertionError(f"vgl_msbfs levels of shape {tuple(lv_ms.shape)}")
    for i in (0, MS_ROOTS // 3, 2 * MS_ROOTS // 3, MS_ROOTS - 1):
        check(f"vgl_msbfs row {i}", lv_ms[i], ms_roots[i])

    # the pull at the bottom-up shape: int8 any01 over GATHER, and MS-BFS's
    # int32 word or
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    g_in = graph.direction(bfs.G)
    xb = (torch.rand(graph.v_pad, device=DEVICE, generator=gen) < 0.05) \
        .to(torch.int8)
    xi = torch.randint(-2**31, 2**31 - 1, (graph.v_pad,), device=DEVICE,
                       generator=gen, dtype=torch.int32)
    pull_err = max(
        _pull_check(pl, f"RMAT-{BFS_SCALE} G i8 any01", g_in, xb, "any01",
                    False),
        _pull_check(pl, f"RMAT-{BFS_SCALE} G i32 or", g_in, xi, "or", False))
    pull = _pull_times(pl, g_in, xb, "any01", False,
                       f"RMAT-{BFS_SCALE} G i8 any01", smi)
    pull["max_err"] = pull_err

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
    return roots[0], totals, pull


def _sssp_sources(ec) -> list:
    """The sources bench.py times SSSP from: the DO-BFS roots, seeds 100+s."""
    from vectorgraphlibrary_tpu_torch.models import common
    return [common.select_random_source(ec, seed=100 + s) for s in range(2)]


def phase_weighted_kernels(rg, pl, scm, ec, graph, ea, smi: str) -> dict:
    """pull_reduce with edge weights and scatter_combine in f32 against their
    plain versions at the fixpoint family's shapes (the weighted RMAT-20
    graph), their times, bounds and one-call PyTorch times, and the host's
    cost of one launch."""
    from vectorgraphlibrary_tpu_torch.models import bfs, sssp
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    v_pad = graph.v_pad
    g_in, g_out = graph.direction(bfs.G), graph.direction(bfs.S)
    w_in = ea.incoming.flat
    # distances as a sweep of the middle of a run sees them: a third of the
    # vertices not reached yet
    dist = torch.rand(v_pad, device=dev, generator=gen) * 300
    dist[torch.rand(v_pad, device=dev, generator=gen) < 0.3] = torch.inf
    caps = torch.rand(v_pad, device=dev, generator=gen) * 100
    caps[torch.rand(v_pad, device=dev, generator=gen) < 0.3] = 0.0
    xf = torch.rand(v_pad, device=dev, generator=gen)
    labels = torch.randint(0, graph.v, (v_pad,), device=dev, generator=gen,
                           dtype=torch.int32)
    tag = f"RMAT-{BFS_SCALE}"
    pull_err = max(
        _pull_check(pl, f"{tag} G f32 min of x + w", g_in, dist, "min", False,
                    w_in, "add"),
        _pull_check(pl, f"{tag} G f32 max of min(x, w)", g_in, caps, "max",
                    False, w_in, "min"),
        _pull_check(pl, f"{tag} S f32 min of x + w, no self-loops", g_out,
                    dist, "min", True, ea.outgoing.flat, "add"),
        _pull_check(pl, f"{tag} G i32 min", g_in, labels, "min", False),
        _pull_check(pl, f"{tag} S i32 min", g_out, labels, "min", False),
        _pull_check(pl, f"{tag} G f32 add", g_in, xf, "add", False),
        _pull_check(pl, f"{tag} S f32 add", g_out, xf, "add", False))
    pulls = {
        "sssp_min_add": _pull_times(pl, g_in, dist, "min", False,
                                    f"{tag} G f32 min of x + w", smi, w_in,
                                    "add"),
        "sswp_max_min": _pull_times(pl, g_in, caps, "max", False,
                                    f"{tag} G f32 max of min(x, w)", smi,
                                    w_in, "min"),
        "hits_add_g": _pull_times(pl, g_in, xf, "add", False,
                                  f"{tag} G f32 add", smi),
        "hits_add_s": _pull_times(pl, g_out, xf, "add", False,
                                  f"{tag} S f32 add", smi),
        "cc_min_g": _pull_times(pl, g_in, labels, "min", False,
                                f"{tag} G i32 min", smi),
        "cc_min_s": _pull_times(pl, g_out, labels, "min", False,
                                f"{tag} S i32 min", smi),
    }
    # one-call PyTorch for the f32 add: cuSPARSE SpMV of the CSR with 1.0
    # per edge; there is none for the min-plus, max-min and int32 min pulls
    for key, dg in (("hits_add_g", g_in), ("hits_add_s", g_out)):
        a = torch.sparse_csr_tensor(
            dg.row_ptr, dg.col_idx[:dg.e],
            torch.ones(dg.e, device=dev), size=(v_pad, v_pad))
        pulls[key]["library_ms"] = _median3(
            f"pull_reduce {tag} {key[-1].upper()} f32 add, torch.mv of a CSR "
            f"tensor", "ms", [_cuda_ms(lambda: torch.mv(a, xf))
                              for _ in range(3)], smi)
        del a
    for r in pulls.values():
        r.setdefault("library_ms", None)

    # scatter_combine f32: dropped, duplicate and inf entries, bit for bit
    rng = np.random.default_rng(SEED + 2)
    v = graph.v_pad

    def f32(n, scale=300.0):
        return torch.from_numpy(
            (rng.random(n) * scale).astype(np.float32)).to(dev)
    target = f32(v)
    target[::3] = torch.inf
    cases = []
    for lg in (13, 16):
        d = rng.integers(0, v, 1 << lg)
        d[rng.permutation(1 << lg)[:(1 << lg) // 8]] = v       # dropped
        cases.append((f"2^{lg} messages", d))
    cases.append(("2^16 messages onto 5 targets", rng.integers(0, 5, 1 << 16)))
    cases.append(("all dropped", np.full(1 << 12, v)))
    cases.append(("no message", np.zeros(0, np.int64)))
    sc_err = 0.0
    for label, d in cases:
        idx = torch.from_numpy(d.astype(np.int32)).to(dev)
        msg = f32(idx.shape[0]) - 100.0                 # both signs
        msg[::11] = torch.inf
        msg[5::13] = -torch.inf
        for op, base in (("min", target), ("max", -target)):
            for m in (msg, 42.5):
                got = scm.scatter_combine(base, idx, m, op)
                want = scm.scatter_combine_ref(base, idx, m, op)
                torch.cuda.synchronize()
                ok = torch.equal(_bits(got), _bits(want))
                err = torch.where(got == want, 0.0,
                                  (got.double() - want.double()).abs()) \
                    .max().item()
                sc_err = max(sc_err, err)
                if not ok:
                    raise AssertionError(f"scatter_combine f32 != plain "
                                         f"version: {label} {op}")
        print(f"  scatter_combine f32 {label}: min and max bit-exact, tensor "
              f"and constant messages")

    # the largest push a partial SSSP run makes: its tier's edge capacity
    trace = []
    sssp.vgl_dijkstra_partial_device(graph, ea, _sssp_sources(ec)[0],
                                     trace=trace)
    ecap = max((t[2] for t in trace if t[0] == "push"), default=1 << 16)
    print(f"  partial SSSP sweeps: {[t[0] for t in trace]}; largest push "
          f"capacity {ecap}")
    d = rng.integers(0, v, ecap)
    d[rng.permutation(ecap)[:ecap // 8]] = v
    idx = torch.from_numpy(d.astype(np.int32)).to(dev)
    msg = f32(ecap)
    label = f"scatter_combine f32 min {ecap} -> 2^20"
    k_ms = _median3(f"{label}, kernel", "ms", [_cuda_ms(
        lambda: scm.scatter_combine(target, idx, msg, "min"))
        for _ in range(3)], smi)
    p_ms = _median3(f"{label}, plain", "ms", [_cuda_ms(
        lambda: scm.scatter_combine_ref(target, idx, msg, "min"))
        for _ in range(3)], smi)
    keep = idx < v
    idx_in, msg_in = idx[keep].long(), msg[keep]
    lib_ms = _median3(f"{label}, scatter_reduce", "ms", [_cuda_ms(
        lambda: torch.scatter_reduce(target, 0, idx_in, msg_in, "amin"))
        for _ in range(3)], smi)
    dev_k = _profiled_ms(lambda: scm.scatter_combine(target, idx, msg, "min"))
    dev_l = _profiled_ms(lambda: torch.scatter_reduce(target, 0, idx_in,
                                                      msg_in, "amin"))
    # bytes it must move: the target read and its copy written, every index
    # and message, the messages that land
    bound = _bound_ms(8 * v + 8 * ecap + 4 * idx_in.shape[0])
    print(f"  {label}, device ms per call by torch.profiler: "
          f"{json.dumps(dev_k)}; scatter_reduce: {json.dumps(dev_l)}; bound "
          f"{bound:.4f} ms")
    scatter = dict(max_err=sc_err, ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                   bound_ms=bound, device_ms=dev_k["total"],
                   library_device_ms=dev_l["total"], messages=ecap)

    # what one launch through build.entry and ctypes costs on the host: the
    # smallest route call (128 slots; its device time is a few microseconds)
    x = torch.arange(128, dtype=torch.int32, device=dev)
    ix = torch.arange(127, -1, -1, dtype=torch.int32, device=dev)
    ev_k = _median3("route_gather_finish 128 slots, kernel by events", "ms",
                    [_cuda_ms(lambda: rg.route_gather_finish(x, ix), reps=100)
                     for _ in range(3)], smi)
    ev_l = _median3("route_gather_finish 128 slots, index_select by events",
                    "ms", [_cuda_ms(lambda: torch.index_select(x, 0, ix),
                                    reps=100) for _ in range(3)], smi)
    ev_e = _median3("route_gather_finish 128 slots, torch.empty alone", "ms",
                    [_cuda_ms(lambda: torch.empty(128, dtype=torch.int32,
                                                  device=dev), reps=100)
                     for _ in range(3)], smi)
    pd_k = _profiled_ms(lambda: rg.route_gather_finish(x, ix), reps=100)
    pd_l = _profiled_ms(lambda: torch.index_select(x, 0, ix), reps=100)
    print(f"  one launch of 128 slots: kernel {ev_k:.4f} ms by events and "
          f"{pd_k['total']:.4f} ms on the device; index_select {ev_l:.4f} and "
          f"{pd_l['total']:.4f}; the host's share of a wrapper call is "
          f"{ev_k - pd_k['total']:.4f} ms")
    launch = dict(kernel_events_ms=ev_k, kernel_device_ms=pd_k["total"],
                  index_select_events_ms=ev_l,
                  index_select_device_ms=pd_l["total"], empty_events_ms=ev_e)
    return dict(pull_err=pull_err, pulls=pulls, scatter=scatter, launch=launch)


def _timed3(fn) -> list:
    """Wall seconds of three calls, each ending in a synchronize."""
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def phase_fixpoint(kernels: dict, ec, graph, ea, smi: str) -> dict:
    """SSSP (all-active and partial), SSWP, CC (Shiloach-Vishkin and the
    flood hybrid) and HITS on the weighted RMAT-20 graph through the port's
    entry points, each checked against its oracle and its launch counts;
    returns the kernels' launch counts over those calls."""
    from vectorgraphlibrary_tpu_torch.graph.vertices import as_original_numpy
    from vectorgraphlibrary_tpu_torch.models import cc, hits, sssp, sswp
    from vectorgraphlibrary_tpu_torch.utils.verify import (
        equal_components, verify_ranking_results, verify_results)
    totals = dict.fromkeys(kernels, 0)
    e = graph.e

    def counted(label, fn, want: dict):
        """fn() with the counts set to 0 just before and read just after;
        `want` maps kernel names to the launches expected (0 if absent)."""
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = {name: k.launches for name, k in kernels.items()}
        for name in totals:
            totals[name] += n[name]
        expect = dict.fromkeys(kernels, 0)
        expect.update(want(out) if callable(want) else want)
        print(f"  {label}: {dt:.4f} s, launches "
              f"{ {k: c for k, c in n.items() if c} }")
        if n != expect:
            raise AssertionError(f"{label}: launches {n}, expected {expect}")
        return out

    def mteps(label, fn, work: float):
        times = _timed3(fn)
        print(f"  {label} s per call: {', '.join(f'{t:.5f}' for t in times)}")
        return _median3(f"{label} RMAT-{BFS_SCALE} MTEPS", "MTEPS",
                        [work / t / 1e6 for t in times], smi)

    def check(label, errors):
        if errors:
            raise AssertionError(f"{label}: error count {errors}")

    torch.cuda.reset_peak_memory_stats()
    sources = _sssp_sources(ec)
    rates = {}
    for src in sources:
        dist, iters = counted(
            f"vgl_dijkstra_all_active source {src}",
            lambda: sssp.vgl_dijkstra_all_active(graph, ea, src),
            lambda out: dict(pull_reduce=out[1]))
        if dist.values.shape != (graph.v_pad,) \
                or dist.values.dtype != torch.float32:
            raise AssertionError("distances are not f32 [v_pad]")
        print(f"    {iters} sweeps")
        check(f"SSSP source {src}", verify_results(
            as_original_numpy(dist, graph), sssp.seq_dijkstra(ec, src)))
        trace = []
        part, p_iters = counted(
            f"vgl_dijkstra_partial_device source {src}",
            lambda: sssp.vgl_dijkstra_partial_device(graph, ea, src,
                                                     trace=trace),
            # a sparse sweep: the owner mark and the f32 min, the state
            # routed to SCATTER order and back; a dense sweep: one pull; the
            # out-degrees' route before the loop
            lambda out: dict(
                scatter_combine=2 * sum(t[0] == "push" for t in trace),
                route_gather_finish=3 * sum(t[0] == "push" for t in trace) + 1,
                pull_reduce=sum(t[0] == "dense" for t in trace)))
        print(f"    {p_iters} sweeps: "
              f"{' '.join('p' if t[0] == 'push' else 'D' for t in trace)}")
        if p_iters != len(trace) or not any(t[0] == "push" for t in trace):
            raise AssertionError("the partial run made no sparse sweep")
        if not torch.equal(_bits(part.values), _bits(dist.values)):
            raise AssertionError(f"partial SSSP differs from all-active, "
                                 f"source {src}")
        print("    partial-active distances equal all-active's bit for bit")
    src = sources[0]
    rates["sssp"] = mteps(
        "SSSP all-active", lambda: sssp.vgl_dijkstra_all_active(
            graph, ea, src), e)
    rates["sssp_iters"] = iters_aa = sssp.vgl_dijkstra_all_active(
        graph, ea, src)[1]
    rates["sssp_periter"] = rates["sssp"] * iters_aa
    print(f"  SSSP all-active per-sweep MTEPS median {rates['sssp_periter']:.4f}"
          f" ({iters_aa} sweeps) on {smi}")
    rates["sssp_partial"] = mteps(
        "SSSP partial-active", lambda: sssp.vgl_dijkstra_partial_device(
            graph, ea, src), e)

    caps, w_iters = counted(
        f"vgl_widest_paths source {src}",
        lambda: sswp.vgl_widest_paths(graph, ea, src),
        lambda out: dict(pull_reduce=out[1]))
    print(f"    {w_iters} sweeps")
    check("SSWP", verify_results(as_original_numpy(caps, graph),
                                 sswp.seq_widest_paths(ec, src)))
    rates["sswp"] = mteps("SSWP", lambda: sswp.vgl_widest_paths(
        graph, ea, src), e)

    want_cc = cc.seq_cc(ec)
    labels, sv_iters = counted(
        "vgl_shiloach_vishkin", lambda: cc.vgl_shiloach_vishkin(graph),
        lambda out: dict(pull_reduce=2 * out[1],
                         route_gather_finish=4 * out[1]))
    print(f"    {sv_iters} iterations")
    if labels.values.dtype != torch.int32:
        raise AssertionError("labels are not int32")
    check("CC Shiloach-Vishkin", equal_components(
        labels.values[:graph.v].cpu().numpy(), want_cc))
    for k in kernels.values():
        k.launches = 0
    hybrid, hy_iters = cc.vgl_cc_hybrid(graph)
    torch.cuda.synchronize()
    print(f"  vgl_cc_hybrid: {hy_iters} hook iterations, launches "
          f"{ {n: k.launches for n, k in kernels.items() if k.launches} }")
    for name, k in kernels.items():
        totals[name] += k.launches
    check("CC flood hybrid", equal_components(
        hybrid.values[:graph.v].cpu().numpy(), want_cc))
    rates["cc_sv"] = mteps("CC Shiloach-Vishkin",
                           lambda: cc.vgl_shiloach_vishkin(graph), e)
    rates["cc_sv_iters"] = sv_iters
    rates["cc_sv_periter"] = rates["cc_sv"] * 2 * sv_iters
    print(f"  CC Shiloach-Vishkin per-pull MTEPS median "
          f"{rates['cc_sv_periter']:.4f} ({2 * sv_iters} pulls) on {smi}")
    rates["cc_hybrid"] = mteps("CC flood hybrid",
                               lambda: cc.vgl_cc_hybrid(graph), e)

    n_it = 20
    auth, hub = counted(
        f"vgl_hits {n_it} iterations", lambda: hits.vgl_hits(graph, n_it),
        dict(pull_reduce=2 * n_it, route_gather_finish=2 * n_it + 2))
    want_auth, want_hub = hits.seq_hits(ec, iterations=n_it)
    for label, got, want in (("auth", auth, want_auth), ("hub", hub, want_hub)):
        vals = got.values
        if vals.shape != (graph.v_pad,) or not bool(torch.isfinite(vals).all()):
            raise AssertionError(f"HITS {label} is not finite [v_pad]")
        check(f"HITS {label}", verify_ranking_results(
            vals[:graph.v].cpu().numpy(), want))
    rates["hits"] = mteps("HITS", lambda: hits.vgl_hits(graph, n_it), e * n_it)
    print(f"  fixpoint family peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB on {smi}")
    return dict(launches=totals, rates=rates)


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


def phase_persistence(kernels: dict, fresh: dict, router_s: float,
                      smi: str) -> dict:
    """Save the phase-4 graph, load it on the card (full and slim), and run
    PageRank and one DO-BFS root on the loaded graph; returns the kernels'
    launch counts on this path."""
    from vectorgraphlibrary_tpu_torch.graph.persistence import (
        load_graph_from_binary_file, save_graph_to_binary_file)
    from vectorgraphlibrary_tpu_torch.graph.vertices import as_original_numpy
    from vectorgraphlibrary_tpu_torch.models import bfs, common, pr
    from vectorgraphlibrary_tpu_torch.utils.verify import verify_ranking_results

    ls = kernels["lane_shuffle"]
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

        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        g = load_graph_from_binary_file(path, device=DEVICE)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        n_ls = ls.launches
        ranks, _ = pr.vgl_page_rank(g, max_iterations=ITERS,
                                    use_convergence=False)
        lv = bfs.vgl_bfs_device(g, src).values
        torch.cuda.synchronize()
        counts = {name: k.launches for name, k in kernels.items()}
        print(f"  load on {DEVICE}: {load_s:.2f} s; launches on this path "
              f"(load, vgl_page_rank, one DO-BFS root): {counts}")
        if n_ls != 8:
            raise AssertionError(f"load launched lane_shuffle {n_ls} times, "
                                 "expected 8 (two per plan)")
        if counts["scatter_combine"] or not all(
                v for k, v in counts.items() if k != "scatter_combine"):
            raise AssertionError(f"a kernel of this path did not launch, or "
                                 f"scatter_combine did: {counts}")
        _assert_same_graph("loaded graph", g, graph)

        vals = ranks.values
        same = torch.equal(vals, fresh["ranks"])
        print(f"  PageRank on the loaded graph: "
              f"{'bit-identical to' if same else 'DIFFERS from'} phase 4")
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
        ls.launches = 0
        t0 = time.perf_counter()
        g = load_graph_from_binary_file(slim, device=DEVICE)
        torch.cuda.synchronize()
        print(f"  slim load (word masks only, "
              f"{os.path.getsize(slim) / 2**20:.1f} MiB): "
              f"{time.perf_counter() - t0:.2f} s, lane_shuffle launches "
              f"{ls.launches}")
        if ls.launches != 8:
            raise AssertionError("slim load: expected 8 lane_shuffle launches")
        _assert_same_graph("slim-loaded graph", g, graph)
    return counts


def profile(pl, pr_graph, bfs_graph, bfs_root, ec, ea, out_dir: str) -> None:
    """Device time by kernel of one call of each slice, beside its wall time
    without the profiler, to DIR/<slice>_profile.txt and the output. A
    window in which the profiler recorded fewer pull_reduce kernels than
    the wrapper launched is taken again (three times at most) and marked
    INCOMPLETE if it stays short."""
    from vectorgraphlibrary_tpu_torch.models import bfs, hits, pr, sssp
    os.makedirs(out_dir, exist_ok=True)
    src = _sssp_sources(ec)[0]
    runs = (("pr_profile.txt", lambda: pr.vgl_page_rank(
                pr_graph, max_iterations=10, use_convergence=False)),
            ("bfs_do_profile.txt",
             lambda: bfs.vgl_bfs_device(bfs_graph, bfs_root)),
            ("sssp_all_active_profile.txt",
             lambda: sssp.vgl_dijkstra_all_active(bfs_graph, ea, src)),
            ("hits_profile.txt", lambda: hits.vgl_hits(bfs_graph, 20)))
    for fname, fn in runs:
        pl.pull_reduce.launches = 0
        wall = min(_timed3(fn))
        want = pl.pull_reduce.launches // 3
        for _ in range(3):
            dev = _device_events(fn)
            seen = sum("pull_reduce_kernel" in e.name for e in dev)
            if seen == want:
                break
        total = sum(e.time_range.elapsed_us() for e in dev) / 1e3
        by_name: dict = {}
        for e in dev:
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
        lines = [f"{fname}: {len(dev)} device events (kernels and copies), "
                 f"{total:.4f} ms of device time; {wall * 1e3:.4f} ms of wall "
                 f"time without the profiler (the least of 3): the card is "
                 f"busy {100 * total / (wall * 1e3):.1f} % of it"
                 + ("" if seen == want else f"; INCOMPLETE: {seen} of {want} "
                    f"pull_reduce launches recorded")]
        for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1]):
            lines.append(f"  {t:9.4f} ms {100 * t / total:5.1f} % {n:5d} x  "
                         f"{name[:110]}")
        with open(os.path.join(out_dir, fname), "w") as f:
            f.write("\n".join(lines) + "\n")
        print("\n".join(lines[:13]))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.manual_seed(SEED)
    from vectorgraphlibrary_tpu_torch.ops.cuda import build
    from vectorgraphlibrary_tpu_torch.ops.cuda import lane_shuffle as ls
    from vectorgraphlibrary_tpu_torch.ops.cuda import pull_reduce as pl
    from vectorgraphlibrary_tpu_torch.ops.cuda import push_expand as pe
    from vectorgraphlibrary_tpu_torch.ops.cuda import route_gather as rg
    from vectorgraphlibrary_tpu_torch.ops.cuda import scatter_combine as scm

    name = torch.cuda.get_device_name(0)
    smi = _smi()
    print(f"[1/10] device: {name} ({torch.cuda.device_count()} visible); "
          f"nvidia-smi: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")

    t0 = time.perf_counter()
    build.load_library()
    ptxas = [ln.strip() for ln in build.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[2/10] build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{build.build_seconds:.2f} s, one process per source, sm_90a); "
          f"ptxas: " + " | ".join(ptxas))

    print("[3/10] kernel: route_gather_finish vs plain version, n = 2^24")
    max_err, rand_ms, rand_plain_ms = phase_kernel(rg)

    print(f"[4/10] slice: PageRank on RMAT-{SCALE}, and pull_reduce vs plain "
          f"version on its graph")
    prr = phase_pagerank(rg, pl, smi)
    prr["route"]["max_err"] = max(max_err, prr["route"]["max_err"])

    print(f"[5/10] kernel: scatter_combine vs plain version, V = 2^20, and "
          f"push_expand vs plain version on RMAT-{BFS_SCALE}")
    bfs_ec, bfs_graph, bfs_ea = make_bfs_graph()
    push = phase_scatter(scm, pe, bfs_graph, smi)

    print(f"[6/10] slice: BFS on RMAT-{BFS_SCALE}")
    bfs_root, bfs_launches, pull20 = phase_bfs(rg, pl, pe, scm, bfs_ec,
                                               bfs_graph, smi)

    print(f"[7/10] kernel: lane_shuffle vs plain version, "
          f"[{prr['graph'].advance_route.n // 128}, 128]")
    lsr = phase_lane_shuffle(ls, prr["graph"], smi)

    print(f"[8/10] slice: save and load RMAT-{SCALE}, then PageRank and BFS "
          f"on the loaded graph")
    kernels = dict(lane_shuffle=ls.lane_shuffle,
                   route_gather_finish=rg.route_gather_finish,
                   pull_reduce=pl.pull_reduce, push_expand=pe.push_expand,
                   scatter_combine=scm.scatter_combine)
    loaded = phase_persistence(kernels, prr, lsr["router_s"], smi)

    print(f"[9/10] kernel: pull_reduce with edge weights and scatter_combine "
          f"f32 vs plain versions on weighted RMAT-{BFS_SCALE}, and the "
          f"host's cost of one launch")
    wk = phase_weighted_kernels(rg, pl, scm, bfs_ec, bfs_graph, bfs_ea, smi)

    print(f"[10/10] slice: SSSP, SSWP, CC and HITS on weighted "
          f"RMAT-{BFS_SCALE}")
    fix = phase_fixpoint(kernels, bfs_ec, bfs_graph, bfs_ea, smi)
    prr["pull"]["max_err"] = max(prr["pull"]["max_err"], wk["pull_err"])
    push["scatter"]["max_err"] = max(push["scatter"]["max_err"],
                                     wk["scatter"]["max_err"])

    if "--profile" in sys.argv:
        profile(pl, prr["graph"], bfs_graph, bfs_root, bfs_ec, bfs_ea,
                sys.argv[sys.argv.index("--profile") + 1])

    def times(r: dict) -> dict:
        return {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")}

    def paths(kernel: str) -> dict:
        by_path = {f"pagerank_rmat{SCALE}": prr["launches"].get(kernel, 0),
                   f"bfs_do_rmat{BFS_SCALE}": bfs_launches.get(kernel, 0),
                   f"loaded_rmat{SCALE}": loaded[kernel],
                   f"fixpoint_rmat{BFS_SCALE}": fix["launches"][kernel]}
        if kernel == "scatter_combine":
            by_path["exp_push"] = push["scatter"]["launches"]
        return by_path

    def row(kernel: str, source: str, replaces: str, r: dict, **extra):
        by_path = paths(kernel)
        return {"name": kernel, "route": "cuda",
                "source": f"vectorgraphlibrary_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path, "max_abs_err": r["max_err"],
                **times(r), "bound_by": "bytes", **extra}
    route = prr["route"]
    print(smi)
    print(json.dumps({"kernels": [
        row("route_gather_finish", "route_gather.cu", REPLACES, route,
            random_perm_2p24_ms=rand_ms,
            random_perm_2p24_plain_ms=rand_plain_ms,
            device_ms=route["device_ms"],
            library_device_ms=route["library_device_ms"],
            one_launch_128_slots=wk["launch"],
            **{k: v for k, v in route.items() if k.startswith("advance_")}),
        row("pull_reduce", "pull_reduce.cu", REPLACES, prr["pull"],
            rmat20_i8_any01_ms=pull20["ms"],
            rmat20_i8_any01_plain_ms=pull20["plain_ms"],
            rmat20_i8_any01_bound_ms=pull20["bound_ms"],
            rmat20_max_abs_err=pull20["max_err"],
            rmat20_weighted={k: times(r) for k, r in wk["pulls"].items()}),
        row("scatter_combine", "scatter_combine.cu", REPLACES_SCATTER,
            push["scatter"], device_ms=push["scatter"]["device_ms"],
            library_device_ms=push["scatter"]["library_device_ms"],
            f32_min={k: v for k, v in wk["scatter"].items()}),
        row("push_expand", "push_expand.cu", REPLACES_SCATTER, push["push"],
            device_ms=push["push"]["device_ms"]),
        row("lane_shuffle", "lane_shuffle.cu", REPLACES_LANE, lsr)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
