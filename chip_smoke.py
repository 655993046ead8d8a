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
6. slice: BFS on RMAT-20 (average degree 16, seed 42, unweighted) through
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

The line before the last is {"kernels": [...]}: for each kernel its launches
on each path, its error against the plain version, and its time, its plain
version's time, the one-call PyTorch time (library_ms, null where there is
none) and its bound (bound_ms: the bytes it must move at the H100's 3.35
TB/s) at the main path's shapes. The last line is {"ok": true, "device":
{...}}. --profile DIR also writes torch.profiler tables of one 10-iteration
PageRank run and one DO-BFS root to DIR (not part of the default run).
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


def _pull_check(pl, label: str, dg, x, op: str, excl: bool) -> float:
    """pull_reduce against its plain version on the same inputs, with the
    graph's work units: f32 sums at rtol 1e-5 / atol 1e-6 (the plain version
    sums each row in another order), everything else exactly. Returns the
    max abs error."""
    from vectorgraphlibrary_tpu_torch.ops.advance import row_groups
    got = pl.pull_reduce(dg.row_ptr, dg.col_idx, x, op, excl, row_groups(dg))
    want = pl.pull_reduce_ref(dg.row_ptr, dg.col_idx, x, op, excl)
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


def _pull_times(pl, dg, x, op: str, excl: bool, label: str, smi: str) -> dict:
    """Kernel and plain version on the same pull, medians of 3, each the mean
    of 10 launches."""
    from vectorgraphlibrary_tpu_torch.ops.advance import row_groups
    groups = row_groups(dg)
    k_ms = _median3(f"pull_reduce {label}, kernel", "ms",
                    [_cuda_ms(lambda: pl.pull_reduce(
                        dg.row_ptr, dg.col_idx, x, op, excl, groups))
                     for _ in range(3)], smi)
    p_ms = _median3(f"pull_reduce {label}, plain", "ms",
                    [_cuda_ms(lambda: pl.pull_reduce_ref(
                        dg.row_ptr, dg.col_idx, x, op, excl))
                     for _ in range(3)], smi)
    # bytes it must move: row_ptr, col_idx of the real edges, x, out
    bound = _bound_ms((dg.v_pad + 1) * 4 + dg.e * 4
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
                 bound_ms=bound, advance_route_2p24_ms=adv_ms,
                 advance_route_2p24_plain_ms=adv_plain_ms,
                 advance_route_2p24_bound_ms=adv_bound)
    return dict(graph=graph, ec=ec, ranks=vals, oracle=want,
                launches=launches, route=route, pull=pull)


def _median3(label: str, unit: str, values, smi: str) -> float:
    v = sorted(values)
    print(f"  {label}: median {v[1]:.4f} {unit} (min {v[0]:.4f}, max "
          f"{v[2]:.4f}) on {smi}")
    return v[1]


def _profiled_ms(fn, reps: int = 10) -> dict:
    """Device time per call by torch.profiler over `reps` calls, in ms: each
    device event's name (kernels, copies) with its total, and "total"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
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
    from vectorgraphlibrary_tpu_torch.graph.device import import_graph
    from vectorgraphlibrary_tpu_torch.io import generation
    t0 = time.perf_counter()
    ec = generation.rmat(BFS_SCALE, BFS_DEGREE, seed=SEED, weighted=False)
    t1 = time.perf_counter()
    graph = import_graph(ec, device=DEVICE)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"  RMAT-{BFS_SCALE}: |V|={graph.v} |E|={graph.e}, generate "
          f"{t1 - t0:.2f} s, import {t2 - t1:.2f} s")
    return ec, graph


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


def profile(pr_graph, bfs_graph, bfs_root, out_dir: str) -> None:
    from torch.autograd import DeviceType
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
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        total = sum(e.time_range.elapsed_us() for e in dev) / 1e3
        head = (f"{fname}: {len(dev)} device events (kernels and copies), "
                f"{total:.4f} ms of device time")
        with open(os.path.join(out_dir, fname), "w") as f:
            f.write(head + "\n" + table)
        print(head)
        print("\n".join(table.splitlines()[:24]))


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

    print(f"[4/8] slice: PageRank on RMAT-{SCALE}, and pull_reduce vs plain "
          f"version on its graph")
    prr = phase_pagerank(rg, pl, smi)
    prr["route"]["max_err"] = max(max_err, prr["route"]["max_err"])

    print(f"[5/8] kernel: scatter_combine vs plain version, V = 2^20, and "
          f"push_expand vs plain version on RMAT-{BFS_SCALE}")
    bfs_ec, bfs_graph = make_bfs_graph()
    push = phase_scatter(scm, pe, bfs_graph, smi)

    print(f"[6/8] slice: BFS on RMAT-{BFS_SCALE}")
    bfs_root, bfs_launches, pull20 = phase_bfs(rg, pl, pe, scm, bfs_ec,
                                               bfs_graph, smi)

    print(f"[7/8] kernel: lane_shuffle vs plain version, "
          f"[{prr['graph'].advance_route.n // 128}, 128]")
    lsr = phase_lane_shuffle(ls, prr["graph"], smi)

    print(f"[8/8] slice: save and load RMAT-{SCALE}, then PageRank and BFS "
          f"on the loaded graph")
    kernels = dict(lane_shuffle=ls.lane_shuffle,
                   route_gather_finish=rg.route_gather_finish,
                   pull_reduce=pl.pull_reduce, push_expand=pe.push_expand,
                   scatter_combine=scm.scatter_combine)
    loaded = phase_persistence(kernels, prr, lsr["router_s"], smi)

    if "--profile" in sys.argv:
        profile(prr["graph"], bfs_graph, bfs_root,
                sys.argv[sys.argv.index("--profile") + 1])

    def times(r: dict) -> dict:
        return {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")}

    def paths(kernel: str) -> dict:
        by_path = {f"pagerank_rmat{SCALE}": prr["launches"].get(kernel, 0),
                   f"bfs_do_rmat{BFS_SCALE}": bfs_launches.get(kernel, 0),
                   f"loaded_rmat{SCALE}": loaded[kernel]}
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
            **{k: v for k, v in route.items() if k.startswith("advance_")}),
        row("pull_reduce", "pull_reduce.cu", REPLACES, prr["pull"],
            rmat20_i8_any01_ms=pull20["ms"],
            rmat20_i8_any01_plain_ms=pull20["plain_ms"],
            rmat20_i8_any01_bound_ms=pull20["bound_ms"],
            rmat20_max_abs_err=pull20["max_err"]),
        row("scatter_combine", "scatter_combine.cu", REPLACES_SCATTER,
            push["scatter"], device_ms=push["scatter"]["device_ms"],
            library_device_ms=push["scatter"]["library_device_ms"]),
        row("push_expand", "push_expand.cu", REPLACES_SCATTER, push["push"],
            device_ms=push["push"]["device_ms"]),
        row("lane_shuffle", "lane_shuffle.cu", REPLACES_LANE, lsr)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
