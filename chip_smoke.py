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
   i32 min, max and or, int8 any01), and on CSRs that put its schedule at
   its edges (every edge in one row, rows of one tile's items and one more
   or less, tiles that start on an empty row, empty rows in the middle and
   at the tail, no edges, one row of one edge: f32 add, i32 min and int8
   any01 with and without self-loops, f32 min of x + w; two f32 add pulls
   bit for bit); its time beside the plain version's and torch.mv of the
   CSR tensor, the time to make its plan (set-up) and the device time of
   each of its kernels per call; the route kernel on the graph's routes,
   timed on the vertex route the path runs and on the 2^24 advance route,
   each on the device in turns with the kernel's first design
   (apps/exp_route_v1.cu, one slot per thread) and beside a copy_ of the
   route's indices (the floor of a launch of that size), and bool vectors
   through the routes (as bytes) equal to a cast to int8;
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
   beside scatter_reduce; what one launch costs on the host (the smallest
   route_gather_finish call by events and by torch.profiler, beside
   index_select, the earlier wrapper path and each step alone); the
   RMAT-20 vertex route by events and on the device, beside
   index_select and its bound, and its int8 route of a byte vector (DO-BFS's
   bottom-up levels), each on the device in turns with the first design
   and beside a copy_ of the indices; and scatter_combine's int32 min of 2^16
   messages into 2^20 (K4's row) again, and its int32 add, beside
   scatter_reduce and index_add, and the in-place entry scatter_combine_
   (min and add, first held bit for bit against the plain version) beside
   index_add_, in turns, by events and on the device, with a bound for
   each entry (in place: the target's sectors that the messages touch);
   then the in-place add step by step: the wrapper, the parent commit's
   wrapper rebuilt, index_add_ and Monoid.scatter_at_ in turns, and each
   step of the launch alone;
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
   formulas, medians of 3;
11. kernel: scatter_combine's int32 add against its plain version, bit for
   bit, into V = 2^20 from 2^15, 2^16 and 2^17 messages (an eighth dropped),
   all dropped and none, and at the triangle count's shape (one column block
   of RMAT-18's degree-oriented edges into its [v + 1, 512] int32 bitmap);
   and_popcount against its plain version, bit for bit, on that block's
   presence-filtered pairs (words = 512) as the count gives them and
   shuffled, a ragged last chunk, runs straddling chunks, an empty edge
   list, and bitmaps of 1, 8, 33 and 512 words with hub rows; kernel,
   plain, one-call PyTorch (index_add; none for and_popcount), bound and
   the design's floor, and the kernel over one triangle count's blocks; the
   bitmap build as models/tc._tc_build_bits runs it (the sorted build,
   scatter_combine_sorted, after a check that the block's indices never
   decrease; bit for bit against its plain version, the copying entry and
   the parent's zero fill + in-place add), timed in turns beside that
   zero fill + scatter_combine_ and torch.zeros + index_add_, against its
   bound, and the count's 16 builds (each block's order checked first)
   beside the same builds by the parent's design and by the copying
   entry;
12. slice: on the phase-4 RMAT-18 graph, vgl_forward_backward
   (equal_components 0 against seq_scc; per trim round 2 pull_reduce and 4
   route_gather_finish, per flood hop 1 and 2), vgl_coloring(ec=...)
   (verify_colors 0; per round 10 pull_reduce and 20 route_gather_finish),
   vgl_label_propagation with 10 rounds (verify_results 0 against the
   vectorised seq_label_propagation), vgl_random_walk (1,024 walkers x 10
   steps, no step off an edge, every end within reach), reachability
   (Purdom) and vgl_bfs_based_reachability from 2 sources (equal to
   seq_reachability), and vgl_triangle_count (325,150,067, equal to the
   oriented sparse product on the host; one scatter_combine launch, its
   sorted build, and one and_popcount per block not skipped, no
   pull_reduce), plus RMAT-14 with
   block_bits 256 against seq_triangle_count; MTEPS by bench.py's formulas
   (coloring |E| / (core s + device s), triangles |E| / (host s + device
   s), SCC and LP |E| / t), medians of 3;
13. slice: GraphSAGE at the widths of OGB's ogbn-products GraphSAGE
   baseline (100 input features, hidden 256, 47 classes) on the RMAT-20
   graph of phase 5 (features and labels from seeds): pull_rows against its
   plain version (run in f64; rtol 1e-5, atol 1e-6) over the GATHER CSR at F
   = 100 and 256 and over the transposed CSR (the backward's) at 256, two
   runs bit-identical, integer-valued rows bit for bit, with kernel, plain,
   torch.sparse.mm times, bound, the all-DRAM floor (every edge's row from
   device memory) and the launch shape (floats per lane, chunk width, and
   the share of edges whose row is read under L2's evict_last);
   aggregate_mean against seq_aggregate_mean; 5 full-aggregation Adam
   steps (exactly 3 pull_rows launches each and no other kernel, finite
   losses, the last below the first), ms per step and peak memory; 3 sampled steps (fan-outs
   25 and 10) on the RMAT-18 graph of phase 4 (no kernel launched);
14. slice: max-flow on the RMAT-18 graph, prepared as apps/mf.py does
   (without self-loops and duplicates, capacities from default_rng(42)),
   on two (source, sink) pairs as the app picks them: vgl_ford_fulkerson
   equal to seq_ford_fulkerson, exactly one pull_reduce launch per BFS
   level, MTEPS by the app's formula (|E| / t), medians of 3;
   vgl_mf_bfs_levels with zero flow equal to seq_top_down's levels (one
   segment_reduce launch per level); the BFS level's pull_reduce (i32 min
   of max(x, w), the sources masked as advance_pull_value masks them, 30 %
   and all of them active) against its plain version, exactly, and its
   times; the general advance_pull (min, max,
   add, with and without a source mask) and segment_reduce (i32 min, f32
   add and max, int8 any01) against their plain versions on the residual
   graph, and segment_reduce's times beside a scatter_reduce by row id;
15. slice: the measurement runtime: runtime/prim_profile's per-primitive
   pass on the RMAT-18 graph of phase 4 and, with its weights, on the
   RMAT-20 graph of phase 9 (the five rows of each table printed, every
   row at or under the card's 3,350 GB/s, and per pass reps + 1 launches of
   route_gather_finish and twice that of pull_reduce and scatter_combine);
   the PageRank app through apps/app_common.run_app as `apps.pr -s 18 -e
   32 -it 3 -check` runs it (error count 0 per round, AVG_PERF, the table
   within the bound, the launches of its rounds, checks and pass);
   apps/ubench_prims at K = 5 (its JSON line); the autotuner's
   collect_samples on RMAT-12 and uniform-12 graphs of degree 8 (the card's
   picks);
16. slice: distribution on one card. (a) parallel/shard_build.import_sharded
   of the weighted RMAT-20 graph in 4 destination shards, and the one-card
   runners pagerank_sharded_scan (100 iterations), bfs_sharded_scan (the
   phase-6 root), sssp_sharded_scan (phase 10's first source, partial),
   cc_sharded_scan and hits_sharded_scan (20 iterations), each equal to
   the unsharded entry points' results (phases 6 and 10; PageRank: this
   phase's vgl_page_rank, error count 0 against seq_page_rank): BFS levels,
   CC labels and SSSP distances exactly, PageRank at rtol 1e-5, HITS at
   rtol 1e-5 and atol 1e-6 of the maximum; per call exactly S pull_reduce
   and 2S route_gather_finish per PageRank iteration and BFS level (3S
   routes per partial SSSP sweep, 2S and 4S per CC and HITS iteration), ms
   (median of 3 by DeviceTimer), MTEPS by bench.py's formulas, peak memory,
   and the sharded graph's device bytes beside the unsharded one's. (b)
   make_pr_sharded and make_bfs_sharded on 2 gloo ranks that share the card
   (CUDA tensors), each building only its own shard from a COO file, and
   at the same time make_pr_sharded on a one-rank NCCL group, equal to the
   same results, with every rank's launches; a rank that fails fails the
   phase. (c) save_sharded_graph of the RMAT-18 graph in 4 shards and
   load_sharded_graph on the card (8 lane_shuffle launches per shard), every
   shard equal to the fresh one and pagerank_sharded_scan on it bit-equal.
17. slice: distribution part 2 on one card. (a) On phase 16's RMAT-20
   shards: msbfs_sharded_scan from 32 roots equal to vgl_msbfs,
   cc_hybrid_sharded_scan from the largest out-degree vertex in phase 10's
   partition; the shards slim (slim_value_pull): their device bytes beside
   the full shards', PageRank, BFS and CC on them bit-equal to the full
   shards'; sssp_sharded_scan_hash partial and all-active bit-equal to each
   other and error count 0 against a host Dijkstra on the hashed weights;
   each call's launches equal to the code's counts (S pulls and 2S routes
   per MS-BFS, BFS level and PageRank iteration, 2S and 4S per CC hybrid
   flood level or hook and CC iteration, S and 3S per partial sweep), ms
   (median of 3 by DeviceTimer), MTEPS and peak memory. (b) coloring,
   partial SSSP, DO-BFS, MS-BFS and CC hybrid on 2 gloo ranks sharing the
   card (RMAT-16) and on a one-rank NCCL group (RMAT-20), equal to the
   one-card results, the colorings valid, every run's launches as the code
   counts them; the sharded GraphSAGE at (100, 256, 47): loss within rtol
   1e-4 and gradients within rtol 1e-4 and atol 1e-6 of the largest entry
   of the unsharded step's, 2 pull_rows launches in the forward and 3 in
   each of 3 Adam steps, whose loss falls, with their ms. (c) phase 16's
   RMAT-18 files and their hashed weights (save_sharded_weights) streamed
   from pinned host memory (load_streamed): PageRank, HITS, MS-BFS, CC
   hybrid and SSSP equal to the resident scans (PageRank and HITS within
   rtol 1e-5), S pulls and 2S routes per sweep (2S and 4S for CC), at most
   two shards resident and the peak memory under two shards with weights
   plus the resident scan's state; the copy's GB/s and each sweep's ms.
   (d) the same files stripped to the JAX package's slim shards
   (persistence.save_jax_slim_sharded: the advance route kept, the CSRs,
   renumber maps and tiles' adjacency dropped) and load_sharded_graph on
   the card, which rebuilds each CSR from the route (timed while (b)'s
   ranks run, as load_streamed is): 8 lane_shuffle launches per shard, as
   the full files' load; every rebuilt CSR and in_route_slots equal to
   phase 16's full load, PageRank, BFS and hashed SSSP bit-equal; both
   loads' seconds.
18. slice: the large tier's path (RMAT-25 at degree 32 is its size; here
   RMAT-20 at degree 32, as one run's time allows). The port's builder,
   apps/build_scale25.py, in a process of its own (this one has a CUDA
   context, and the builder forks) with rmat_fast on every core and as
   many shard workers as there are shards and cores, into a temporary
   cache: 8 shards by the
   destination hash, their edges summing to |E| and the largest under 1.5x
   the smallest; the builder's and the generator's seconds and bytes on
   disk. The graph generated again for the oracles in another process,
   beside the builder, its PageRank constants equal to the builder's. The artifact loaded
   resident (load_sharded_graph, stored weights by slot_weights_stacked)
   and streamed (load_streamed(weights=True)); the device bytes resident
   and the copies' GB/s. PageRank (20 iterations), stored-weight SSSP
   (all-active, from the hub), MS-BFS from 32 roots and CC hybrid in both,
   streamed equal to resident (PageRank bit for bit or within rtol 1e-5,
   the rest exactly), only pull_reduce and route_gather_finish launched (S
   pulls and 2S routes per sweep streamed, 2S and 4S for CC; S and 2S per
   PageRank iteration resident), each call's MTEPS (median of 3 by
   DeviceTimer) and peak memory; PageRank error count 0 against
   seq_page_rank, SSSP within rtol 1e-5 of scipy's dijkstra over the same
   edges (the least weight of repeated edges), CC's component count equal
   to scipy's connected_components.
19. slice: the scale-24 tier's path at RMAT-20/16 (cut from 24 for the
   script's time), the phase-6 graph: apps/build_scale24.py in a process
   of its own into a temporary cache (the shard count that the JAX
   script's rule picks, dst % S edges per shard summing to |E|, "partition":
   "dst-mod"), the host oracles beside it; the artifact loaded resident and
   apps/bench_scale24.py's rows (PageRank, HITS, BFS from vertex 2, MS-BFS
   from 32 roots, partial SSSP on the slot-hash weights, CC hybrid), each
   a median of 3 after a warm-up by DeviceTimer, one row at a time with
   only pull_reduce and route_gather_finish launched (S pulls and 2S
   routes per whole-graph pull, 3S with SSSP's source mask); PageRank
   error count 0 against seq_page_rank, BFS equal to a host BFS, MS-BFS
   equal to the unsharded vgl_msbfs for all 32 roots and to a host BFS for
   2, HITS within rtol 1e-5 (atol 1e-6 of the max) of vgl_hits, SSSP error
   count 0 against scipy's dijkstra on the hashed weights read back from
   the shards, CC's component count equal to scipy's; then
   apps/crosscheck_scale20.crosscheck on the same graph ok.
20. slice: the LiveJournal-scale path at 1/16 (302,973 vertices,
   4,312,110 edges, degree cap 1,250; above 2^22 edges, so SSSP takes the
   partial-active path as at full size): apps/make_lj_replica.replica in
   memory, apps/bench_lj.py's import (no advance route) and its three rows
   (8-source SSSP, 4-hub CC hybrid, 64-root MS-BFS; medians of 3 after a
   warm-up by DeviceTimer), one row at a time with its launches counted
   and held to the path's rules (SSSP: 2 scatter_combine and 3 routes a
   sparse push sweep, 1 route a run; CC and MS-BFS: 2 routes a pull;
   MS-BFS: one pull per level of each word; no other kernel); the rows
   held to the host oracle (apps/exp_lj_oracle.oracle: every CC run's
   labels equal to scipy's weak components up to relabelling, each
   root's reached set and traversed edges exactly, SSSP error count 0
   per source); then at
   this graph's shapes pull_reduce (G f32 min of x + w over SSSP's
   distances, i32 or, int8 any01), the vertex route (i32, f32) and
   scatter_combine's f32 min of 65,536 messages against their plain
   versions, exactly, with their times and bounds.

The line before the last is {"kernels": [...]}: for each kernel its launches
on each path, its error against the plain version, and its time, its plain
version's time, the one-call PyTorch time (library_ms, null where there is
none) and its bound (bound_ms: the bytes it must move at the H100's 3.35
TB/s, or for and_popcount the larger of that and its operations at 67
TOP/s) at the main path's shapes, "rates", phase 12's and 14's MTEPS,
"prim_tables", phase 15's per-primitive tables, "autotuner_picks", and
"sharded", phase 16's numbers, "part2", phase 17's, "tier", phase
18's, "scale24", phase 19's, and "lj", phase 20's.
The last line is {"ok": true, "device":
{...}}. --profile DIR also writes torch.profiler tables of one 10-iteration
PageRank run, one DO-BFS root, one all-active SSSP run and one HITS call to
DIR (not part of the default run), and of one call each of SCC, coloring
(core colors given), LP and the triangle count (orientation given) on
RMAT-18.
"""
from __future__ import annotations

import contextlib
import ctypes
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


# the name of _profiled_ms's one entry when the profiler recorded nothing
EVENTS_FALLBACK = "cuda events (no profiler record)"


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


def _pull_compare(label: str, got, want, op: str) -> float:
    """A pull's result against its plain version's: f32 sums at rtol 1e-5 /
    atol 1e-6 (the plain version sums each row in another order),
    everything else exactly. Returns the max abs error."""
    torch.cuda.synchronize()
    # equal entries (identities of empty rows, inf or not) count as 0
    err = torch.where(got == want, 0.0, (got.double() - want.double()).abs()) \
        .max().item() if got.numel() else 0.0
    if op == "add" and got.dtype == torch.float32:
        ok = bool(torch.isclose(got, want, rtol=1e-5, atol=1e-6).all())
        how = "within rtol 1e-5, atol 1e-6"
    else:
        ok = got.dtype == want.dtype and torch.equal(got, want)
        how = "exact"
    print(f"  pull_reduce {label}: {how if ok else 'MISMATCH'} (max abs err "
          f"{err})")
    if not ok:
        raise AssertionError(f"pull_reduce != plain version: {label}")
    return err


def _pull_check(pl, label: str, dg, x, op: str, excl: bool, weights=None,
                weight_op=None) -> float:
    """pull_reduce against its plain version on the same inputs, with the
    plan the graph keeps (_pull_compare's tolerances). Returns the max abs
    error."""
    from vectorgraphlibrary_tpu_torch.ops.advance import pull_plan
    kw = dict(weights=weights, weight_op=weight_op)
    got = pl.pull_reduce(dg.row_ptr, dg.col_idx, x, op, excl, pull_plan(dg),
                         **kw)
    want = pl.pull_reduce_ref(dg.row_ptr, dg.col_idx, x, op, excl, **kw)
    return _pull_compare(label, got, want, op)


def _adversarial_csrs(g_in, tile: int) -> list:
    """(label, row_ptr, col_idx) of CSRs that put the pull's schedule at its
    edges (tile: merge items per block): every edge of the graph in one
    row; rows of one tile's items, one item more and less; tiles that
    start on an empty row; empty rows between non-empty ones, in the
    middle and at the tail; no edges; one row of one edge."""
    dev = g_in.col_idx.device
    e, v = g_in.e, g_in.v_pad
    rng = np.random.default_rng(SEED + 4)

    def csr(degs):
        degs = np.asarray(degs, np.int64)
        rp = np.concatenate([[0], np.cumsum(degs)]).astype(np.int32)
        ci = rng.integers(0, v, int(rp[-1])).astype(np.int32)
        # self-loops where a row is long enough to hold one
        for r in np.flatnonzero(degs[:v] > 2)[:64]:
            ci[rp[r] + 1] = r
        return (torch.from_numpy(rp).to(dev), torch.from_numpy(ci).to(dev))
    # a tile holds (rows ending in it) + (slots in it) items: a row of
    # tile - 1 slots and its end fill one tile exactly
    run = [tile - 1, tile, tile - 2, 3 * tile - 1, 1, tile + 1, 0, tile - 1]
    # tile - 2 slots and the row end leave one item, an empty row's end, so
    # the next tile starts on an empty row
    on_empty = ([tile - 2] + [0] * 3 + [tile - 4] + [0] * (tile + 5)) * 3
    gaps = rng.choice([0, 0, 0, 1, 2, 7, 40, 300, 5000], size=30000)
    gaps[-2000:] = 0
    cases = [("one row of every RMAT edge",
              torch.tensor([0, e], dtype=torch.int32, device=dev),
              g_in.col_idx[:e])]
    cases += [(label, *csr(d)) for label, d in (
        ("rows of one tile, one more and one less", run),
        ("tiles that start on an empty row", on_empty),
        ("empty rows in the middle and at the tail", gaps),
        ("no edges", [0] * 5000),
        ("one row of one edge", [1]))]
    return cases


def _pull_adversarial(pl, g_in) -> dict:
    """Each adversarial CSR through pull_reduce (with its plan) against the
    plain version: f32 add, i32 min and int8 any01, each with and without
    self-loops, and f32 min of x + w; a second f32 add, bit for bit.
    Returns the max abs error and each CSR's tiles and rows cut."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    n_x = g_in.v_pad
    xf = torch.rand(n_x, device=DEVICE, generator=gen)
    xi = torch.randint(-2**31, 2**31 - 1, (n_x,), device=DEVICE,
                       generator=gen, dtype=torch.int32)
    xb = torch.randint(0, 2, (n_x,), device=DEVICE, generator=gen,
                       dtype=torch.int8)
    dist = xf * 300
    dist[::5] = torch.inf
    err, shapes = 0.0, {}
    for label, rp, ci in _adversarial_csrs(g_in, pl.TILE):
        plan = pl.make_plan(rp)
        shapes[label] = dict(rows=rp.shape[0] - 1, slots=ci.shape[0],
                             tiles=plan.n_tiles, rows_cut=plan.n_fix)
        w = torch.rand(ci.shape[0], device=DEVICE, generator=gen) * 99 + 1
        for name, x, op, excl, kw in (
                ("f32 add", xf, "add", False, {}),
                ("f32 add excl", xf, "add", True, {}),
                ("i32 min", xi, "min", False, {}),
                ("i32 min excl", xi, "min", True, {}),
                ("i8 any01", xb, "any01", False, {}),
                ("i8 any01 excl", xb, "any01", True, {}),
                ("f32 min of x + w", dist, "min", False,
                 dict(weights=w, weight_op="add"))):
            got = pl.pull_reduce(rp, ci, x, op, excl, plan, **kw)
            want = pl.pull_reduce_ref(rp, ci, x, op, excl, **kw)
            err = max(err, _pull_compare(f"{label} ({plan.n_tiles} tiles, "
                                         f"{plan.n_fix} rows cut): {name}",
                                         got, want, op))
            if name == "f32 add":
                again = pl.pull_reduce(rp, ci, x, op, excl, plan, **kw)
                if not torch.equal(_bits(got), _bits(again)):
                    raise AssertionError(f"two f32 add pulls differ: {label}")
    print(f"  pull_reduce on {len(shapes)} adversarial CSRs: every case "
          f"right, two f32 add pulls bit-identical on each")
    return dict(max_err=err, csrs=shapes)


def _pull_times(pl, dg, x, op: str, excl: bool, label: str, smi: str,
                weights=None, weight_op=None) -> dict:
    """Kernel and plain version on the same pull, medians of 3, each the mean
    of 10 launches."""
    from vectorgraphlibrary_tpu_torch.ops.advance import pull_plan
    plan = pull_plan(dg)
    kw = dict(weights=weights, weight_op=weight_op)
    k_ms = _median3(f"pull_reduce {label}, kernel", "ms",
                    [_cuda_ms(lambda: pl.pull_reduce(
                        dg.row_ptr, dg.col_idx, x, op, excl, plan, **kw))
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
    print(f"  pull_reduce {label} bound {bound:.4f} ms ({plan.n_tiles} "
          f"tiles, {plan.n_fix} rows cut)")
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
    adversarial = _pull_adversarial(pl, g_in)
    pull_err = max(pull_err, adversarial["max_err"])
    pull = _pull_times(pl, g_in, xf, "add", True,
                       f"RMAT-{SCALE} G f32 add excl", smi)
    # the schedule's cost (set-up: once per CSR) and the device kernels of
    # one call
    from vectorgraphlibrary_tpu_torch.ops.advance import pull_plan
    plan_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        schedule = pl.make_plan(g_in.row_ptr)
        torch.cuda.synchronize()
        plan_s.append(time.perf_counter() - t0)
    per_call: dict = {}
    for ev in _device_events(lambda: pl.pull_reduce(
            g_in.row_ptr, g_in.col_idx, xf, "add", True, pull_plan(g_in)),
            reps=10):
        per_call[ev.name[:60]] = per_call.get(ev.name[:60], 0.0) \
            + ev.time_range.elapsed_us() / 1e4
    print(f"  pull_reduce RMAT-{SCALE} G plan: {schedule.n_tiles} tiles of "
          f"{pl.TILE} items, {schedule.n_fix} rows cut by a tile boundary, made "
          f"in {statistics.median(plan_s) * 1e3:.3f} ms (median of 3, "
          f"set-up); device ms per call by kernel {per_call}")
    pull.update(plan_build_ms=statistics.median(plan_s) * 1e3,
                tiles=schedule.n_tiles, rows_cut=schedule.n_fix,
                device_kernels_per_call=per_call,
                adversarial=adversarial["csrs"])
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
    # bool vectors ride the routes as their bytes (views): equal to the
    # earlier path, a cast to int8 before the route and back to bool after
    xb = torch.rand(plan.n, device=DEVICE) < 0.3
    for label, rp, inverse, kw in (
            ("vertex route fwd", vplan, False, {}),
            ("vertex route inv", vplan, True, {}),
            ("advance route fwd finish", plan, False,
             dict(flags=plan.flags_fwd, exclude_self_loops=True, ident=0))):
        xv = xb[:rp.n]
        got = apply_route(rp, xv, inverse=inverse,
                          finish=fin if kw else None)
        cast = rg.route_gather_finish(
            xv.to(torch.int8), rp.inv_idx if inverse else rp.fwd_idx, **kw)
        if not kw:
            cast = cast.to(torch.bool)
        ok = got.dtype == cast.dtype and torch.equal(got, cast)
        print(f"  kernel RMAT-{SCALE} bool {label}: "
              f"{'equal to the cast path' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"bool route {label} != cast path")
    vr = _vertex_route_times(rg, vplan, graph.outgoing.degrees,
                             f"RMAT-{SCALE}", smi)
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
    # on the device, in turns with the kernel's first design
    from vectorgraphlibrary_tpu_torch.apps import exp_route
    first = exp_route.first_design()

    def first_fn():
        return first.finish_f32(msgs, plan.fwd_idx, plan.flags_fwd, True, 0.0)
    want_adv = rg.route_gather_finish_ref(
        msgs, plan.fwd_idx, flags=plan.flags_fwd, exclude_self_loops=True,
        ident=0.0)
    if not torch.equal(first_fn().view(torch.int32),
                       want_adv.view(torch.int32)):
        raise AssertionError("the first design's advance route differs from "
                             "the plain version")
    adv_turns = [_one_kernel_ms(f) for f in (
        first_fn, lambda: apply_route(plan, msgs, finish=fin),
        lambda: apply_route(plan, msgs, finish=fin), first_fn)]
    print(f"  RMAT-{SCALE} advance route f32 fwd finish, device ms per call "
          f"by torch.profiler: first design / kernel / kernel / first design "
          f"{adv_turns} on {smi}")
    route = dict(max_err=max_err, **vr, advance_route_2p24_ms=adv_ms,
                 advance_route_2p24_plain_ms=adv_plain_ms,
                 advance_route_2p24_bound_ms=adv_bound,
                 advance_route_2p24_first_tree_tree_first_device_ms=adv_turns)
    return dict(graph=graph, ec=ec, ranks=vals, oracle=want,
                launches=launches, route=route, pull=pull)


def _median3(label: str, unit: str, values, smi: str) -> float:
    """The median of an odd number of runs (three, as a rule), printed
    with their min and max."""
    v = sorted(values)
    mid = v[len(v) // 2]
    print(f"  {label}: median {mid:.4f} {unit} (min {v[0]:.4f}, max "
          f"{v[-1]:.4f}) on {smi}")
    return mid


def _device_events(fn, reps: int = 1) -> list:
    """The device events (kernels, copies) of `reps` calls of fn, by
    torch.profiler. The profiler loses the first kernels after it starts,
    while its activity buffers are set up, so fn runs once inside it first
    and only the events after a marker count. Now and then a window comes
    back without any device event: it is taken again, three times at most,
    and an empty list is returned if every window stays empty."""
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
    return []


def _profiled_ms(fn, reps: int = 10) -> dict:
    """Device time per call by torch.profiler over `reps` calls, in ms: each
    device event's name (kernels, copies) with its total, and "total". Where
    the profiler records no device event (CUPTI tracing is not always
    granted), the time by CUDA events stands in for it under the name
    EVENTS_FALLBACK: it includes the host's launch gaps, so it is an upper
    bound of the device time."""
    by_name: dict = {}
    for e in _device_events(fn, reps):
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + e.time_range.elapsed_us() / reps / 1e3)
    if not by_name:
        print("  torch.profiler recorded no device event: timed by CUDA "
              "events instead")
        by_name[EVENTS_FALLBACK] = _cuda_ms(fn, reps)
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
    """BFS on RMAT-20 through the port's entry points; returns the first
    root, the kernels' launch counts over the 8 vgl_bfs_device calls, the
    pull's check and times at the bottom-up shape (int8 any01 over
    GATHER), and the first root's checked levels (ORIGINAL)."""
    from vectorgraphlibrary_tpu_torch.graph.vertices import (VertexArray,
                                                             as_original_numpy)
    from vectorgraphlibrary_tpu_torch.models import bfs, common
    from vectorgraphlibrary_tpu_torch.utils.verify import verify_results

    def check(label, values, src):
        if values.shape != (graph.v_pad,) or values.dtype != torch.int32:
            raise AssertionError(f"{label}: levels are not int32 [v_pad]")
        got = as_original_numpy(VertexArray(values=values, direction=bfs.S),
                                graph)
        errors = verify_results(got, oracle[src])
        if errors:
            raise AssertionError(f"{label} root {src}: error count {errors}")

    kernels = dict(push_expand=pe.push_expand, pull_reduce=pl.pull_reduce,
                   route_gather_finish=rg.route_gather_finish,
                   scatter_combine=scm.scatter_combine)
    roots = [common.select_random_source(ec, seed=100 + s)
             for s in range(BFS_ROOTS)]
    ms_roots = [common.select_random_source(ec, seed=500 + s)
                for s in range(MS_ROOTS)]
    ms_rows = (0, MS_ROOTS // 3, 2 * MS_ROOTS // 3, MS_ROOTS - 1)
    # seq_top_down's levels from every root checked, one matrix build
    checked = roots + [ms_roots[i] for i in ms_rows]
    t0 = time.perf_counter()
    oracle = dict(zip(checked, bfs.seq_top_down(ec, checked)))
    print(f"  seq_top_down from {len(checked)} roots: "
          f"{time.perf_counter() - t0:.2f} s on the host")
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
        if src == roots[0]:
            root_levels = as_original_numpy(
                VertexArray(values=lv.values, direction=bfs.S), graph)
    if not (totals["push_expand"] and totals["pull_reduce"]):
        raise AssertionError("the DO-BFS run did not launch both kernels")
    for k in kernels.values():
        k.launches = 0
    check("vgl_top_down", bfs.vgl_top_down(graph, roots[0]).values, roots[0])
    check("vgl_bfs -bu", bfs.vgl_bfs(graph, roots[0], alpha=1e-9).values,
          roots[0])
    print(f"  vgl_top_down and vgl_bfs -bu, root {roots[0]}: launches "
          f"{ {name: k.launches for name, k in kernels.items()} }")

    for k in kernels.values():
        k.launches = 0
    lv_ms = bfs.vgl_msbfs(graph, ms_roots).values
    torch.cuda.synchronize()
    print(f"  vgl_msbfs {MS_ROOTS} roots: launches "
          f"{ {name: k.launches for name, k in kernels.items()} }")
    if lv_ms.shape != (MS_ROOTS, graph.v_pad):
        raise AssertionError(f"vgl_msbfs levels of shape {tuple(lv_ms.shape)}")
    for i in ms_rows:
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
    return roots[0], totals, pull, root_levels


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

    k4 = _k4_retime(scm, smi)
    launch = _launch_cost(rg, smi)
    frontier_bytes = (torch.rand(graph.v_pad, device=DEVICE) < 0.3).to(
        torch.int8)
    route = _vertex_route_times(rg, graph.vertex_route_s_from_g,
                                graph.outgoing.degrees, f"RMAT-{BFS_SCALE}",
                                smi, x_bytes=frontier_bytes)
    return dict(pull_err=pull_err, pulls=pulls, scatter=scatter, launch=launch,
                route=route, k4=k4)


def _vertex_route_times(rg, vplan, x, label: str, smi: str,
                        x_bytes=None) -> dict:
    """route_gather_finish on the inverse vertex route of int32 x (the route
    the path runs), by events and on the device (torch.profiler), beside
    index_select and the bound (idx and x read, out written). The event
    times are means of 100 launches, kernel and index_select in turns: at
    these sizes they are the host's cost of a launch. On the device also
    the first design of the kernel (apps/exp_route_v1.cu, the parent's
    source) in turns with it (first, tree, tree, first), and a one-call
    copy_ of the route's indices into an int32 buffer: one pass with no
    dependent read, the floor of a launch of that size. x_bytes: also the
    int8 route of those bytes (DO-BFS's bottom-up levels), on the device
    against the first design, the floor and index_select."""
    from vectorgraphlibrary_tpu_torch.apps import exp_route
    k, lib = [], []
    for _ in range(3):
        k.append(_cuda_ms(lambda: rg.route_gather_finish(x, vplan.inv_idx),
                          reps=100))
        lib.append(_cuda_ms(lambda: torch.index_select(x, 0, vplan.inv_idx),
                            reps=100))
    k_ms = _median3(f"route_gather_finish {label} vertex route i32 inv, "
                    f"kernel", "ms", k, smi)
    lib_ms = _median3(f"route_gather_finish {label} vertex route i32 inv, "
                      f"index_select", "ms", lib, smi)
    p_ms = _median3(f"route_gather_finish {label} vertex route i32 inv, "
                    f"plain", "ms", [_cuda_ms(lambda: rg.route_gather_finish_ref(
                        x, vplan.inv_idx)) for _ in range(3)], smi)
    first = exp_route.first_design()
    floor_out = torch.empty(vplan.n, dtype=torch.int32, device=DEVICE)

    def on_device(xv, name: str, x_size: int) -> dict:
        want = rg.route_gather_finish_ref(xv, vplan.inv_idx)
        for who, got in (("kernel", rg.route_gather_finish(xv, vplan.inv_idx)),
                         ("first design", first.route(xv, vplan.inv_idx))):
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"route_gather {label} {name}: the "
                                     f"{who} differs from the plain version")
        tree_fn = lambda: rg.route_gather_finish(xv, vplan.inv_idx)
        first_fn = lambda: first.route(xv, vplan.inv_idx)
        turns = [_one_kernel_ms(f, reps=20)
                 for f in (first_fn, tree_fn, tree_fn, first_fn)]
        r = dict(device_ms=(None if None in turns[1:3]
                            else (turns[1] + turns[2]) / 2),
                 first_tree_tree_first_device_ms=turns,
                 copy_floor_device_ms=_one_kernel_ms(
                     lambda: floor_out.copy_(vplan.inv_idx), reps=20),
                 library_device_ms=_one_kernel_ms(
                     lambda: torch.index_select(xv, 0, vplan.inv_idx)),
                 bound_ms=_bound_ms(vplan.n * (4 + 2 * x_size)))
        print(f"  route_gather_finish {label} vertex route {name} "
              f"({vplan.n} slots), device ms per call by torch.profiler: "
              f"first design / kernel / kernel / first design "
              f"{turns}; copy_ of its indices {r['copy_floor_device_ms']}; "
              f"index_select {r['library_device_ms']}; bound "
              f"{r['bound_ms']:.4f} on {smi}")
        return r
    r = on_device(x, "i32 inv", 4)
    out = dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, **r)
    if x_bytes is not None:
        out["i8_inv"] = on_device(x_bytes, "i8 inv", 1)
    return out


def _one_kernel_ms(fn, reps: int = 10):
    """Device time of fn, a call that launches one kernel, by torch.profiler:
    the mean over reps calls, from a window that recorded all reps kernels
    (taken again three times at most; the profiler can lose events). None,
    and a line that says so, where no window did."""
    for _ in range(3):
        dev = _device_events(fn, reps)
        if len(dev) == reps:
            return sum(e.time_range.elapsed_us() for e in dev) / reps / 1e3
    print(f"  not measured: torch.profiler recorded {len(dev)} of {reps} "
          f"kernels")
    return None


def _launch_cost(rg, smi: str) -> dict:
    """What one launch costs on the host, step by step: the smallest route
    call (128 slots; its device time is a few microseconds) through the
    wrapper, beside index_select and the earlier wrapper path rebuilt here
    (argument loop on torch.device objects, argument types rebuilt per call,
    torch.cuda.current_stream(device), the device-context check), and each
    step of a launch alone. Every time is by CUDA events around 100 calls,
    median of 3 (the wrapper and index_select in turns): where the steps
    launch nothing, that is host time."""
    dev = torch.device(DEVICE)
    x = torch.arange(128, dtype=torch.int32, device=dev)
    ix = torch.arange(127, -1, -1, dtype=torch.int32, device=dev)
    out = torch.empty_like(x)
    ones = torch.ones(128, dtype=torch.uint8, device=dev)
    plain, finish = rg._PLAIN[torch.int32], rg._FINISH[torch.int32][0]
    index = x.get_device()
    rg.route_gather_finish(x, ix)       # resolves both entries
    rg.route_gather_finish(x, ix, flags=ones)
    fn, fn10 = plain.fn, finish.fn
    entries = {"vgl_route_gather_i32": fn10}

    def old_wrapper():
        for name, t, dtype in (("x", x, x.dtype), ("idx", ix, torch.int32),
                               ("flags", None, torch.uint8),
                               ("weights", None, x.dtype)):
            if t is None:
                continue
            if t.device != x.device or t.dtype != dtype \
                    or not t.is_contiguous():
                raise ValueError(name)
        # build.entry: the argument types listed, then a dict lookup
        argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        f = entries.get("vgl_route_gather_i32", argtypes)
        o = torch.empty(128, dtype=x.dtype, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ctx = (contextlib.nullcontext()
               if x.device.index == torch.cuda.current_device()
               else torch.cuda.device(x.device))
        with ctx:
            rc = f(x.data_ptr(), ix.data_ptr(), None, None, o.data_ptr(),
                   128, 0, 0, 0, stream)
        if rc != 0:
            raise RuntimeError(rc)
        return o

    # the wrapper and index_select in turns, then each step alone
    k, lib = [], []
    for _ in range(3):
        k.append(_cuda_ms(lambda: rg.route_gather_finish(x, ix), reps=100))
        lib.append(_cuda_ms(lambda: torch.index_select(x, 0, ix), reps=100))
    ms = {"wrapper": _median3("one launch, 128 slots: wrapper", "ms", k, smi),
          "index_select": _median3("one launch, 128 slots: index_select",
                                   "ms", lib, smi)}
    steps = {
        "old_wrapper": old_wrapper,
        "torch_empty": lambda: torch.empty(128, dtype=torch.int32,
                                           device=dev),
        "new_empty": lambda: x.new_empty(128),
        "current_stream_object": lambda: torch.cuda.current_stream(
            dev).cuda_stream,
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(index),
        "current_device": torch.cuda.current_device,
        "get_device": x.get_device,
        "data_ptr_x3": lambda: (x.data_ptr(), ix.data_ptr(), out.data_ptr()),
        # the entries return before launching when n = 0: ctypes alone,
        # with the 10 arguments of the finish entry and the 5 of the plain
        "ctypes_call_10_args_n0": lambda: fn10(
            x.data_ptr(), ix.data_ptr(), None, None, out.data_ptr(), 0, 0, 0,
            0, 0),
        "ctypes_call_5_args_n0": lambda: fn(x.data_ptr(), ix.data_ptr(),
                                            out.data_ptr(), 0, 0),
        "launcher_n0": lambda: plain(index, x.data_ptr(), ix.data_ptr(),
                                     out.data_ptr(), 0),
        "launcher_n128": lambda: plain(index, x.data_ptr(), ix.data_ptr(),
                                       out.data_ptr(), 128),
    }
    ms.update({k: _median3(f"one launch, 128 slots: {k}", "ms",
                           [_cuda_ms(f, reps=100) for _ in range(3)], smi)
               for k, f in steps.items()})
    pd_k = _profiled_ms(lambda: rg.route_gather_finish(x, ix), reps=100)
    pd_l = _profiled_ms(lambda: torch.index_select(x, 0, ix), reps=100)
    print(f"  one launch of 128 slots: wrapper {ms['wrapper']:.4f} ms by "
          f"events (the earlier path {ms['old_wrapper']:.4f}) and "
          f"{pd_k['total']:.4f} ms on the device; index_select "
          f"{ms['index_select']:.4f} and {pd_l['total']:.4f}")
    print(f"  launch-path breakdown by events (ms): {json.dumps(ms)}")
    return dict(kernel_events_ms=ms["wrapper"], kernel_device_ms=pd_k["total"],
                index_select_events_ms=ms["index_select"],
                index_select_device_ms=pd_l["total"],
                empty_events_ms=ms["torch_empty"], steps_events_ms=ms)


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
    returns the kernels' launch counts over those calls, the rates, and
    the checked results phase 16 holds the sharded runners to (ORIGINAL
    ordering)."""
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
    t0 = time.perf_counter()
    want_dist = dict(zip(sources, sssp.seq_dijkstra(ec, sources)))
    print(f"  seq_dijkstra from {len(sources)} sources: "
          f"{time.perf_counter() - t0:.2f} s on the host")
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
        dist_o = as_original_numpy(dist, graph)
        check(f"SSSP source {src}", verify_results(dist_o, want_dist[src]))
        if src == sources[0]:
            sssp_o = dist_o
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
    return dict(launches=totals, rates=rates, results=dict(
        sssp_source=sources[0], sssp=sssp_o,
        cc=labels.values[:graph.v].cpu().numpy(),
        hits_auth=auth.values.cpu().numpy(),
        hits_hub=hub.values.cpu().numpy()))


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
        idle = ("scatter_combine", "scatter_combine_sorted", "and_popcount",
                "pull_rows", "segment_reduce")
        if any(counts[k] for k in idle) or not all(
                v for k, v in counts.items() if k not in idle):
            raise AssertionError(f"a kernel of this path did not launch, or "
                                 f"one of {idle} did: {counts}")
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


# H100 SXM non-tensor rate (NVIDIA data sheet, float32 row), used for
# the int32 AND, popcount and add of
# and_popcount: the data sheet gives no integer rate outside the tensor cores
OPS_PER_S = 67e12
TRIANGLES_RMAT18 = 325_150_067        # the JAX package's count, same graph
REPLACES_POPCOUNT = ("none: vectorgraphlibrary_tpu/models/tc.py:112 "
                     "(_tc_block_count) runs outside Pallas")


def _popcount_cases(bits, uf, vf, chunk: int, rng) -> list:
    """and_popcount's cases, each (label, (bits, u, v, chunk)): the triangle
    count's densest block as the count gives it (pairs sorted by u, then
    v), the same pairs shuffled, a ragged last chunk, runs of one u
    straddling chunk boundaries (chunks of 1,000 and of 7), an empty edge
    list, and bitmaps of 1, 8, 33 and 512 words with a tenth of their words
    non-zero and four hub rows with every word non-zero (the dense case;
    at 512 words, past one window of the warp's list), taken by sorted runs
    straddling chunks of 1,000 and shuffled."""
    dev = bits.device
    n = uf.shape[0]
    perm = torch.from_numpy(rng.permutation(n)).to(dev)
    ragged = 3 * chunk + 1234
    cases = [(f"{n} pairs", (bits, uf, vf, chunk)),
             (f"{n} pairs shuffled", (bits, uf[perm], vf[perm], chunk)),
             (f"ragged, {ragged} pairs", (bits, uf[:ragged], vf[:ragged],
                                          chunk)),
             ("runs across chunks of 1000", (bits, uf[:200_000],
                                             vf[:200_000], 1000)),
             ("runs across chunks of 7", (bits, uf[:20_000], vf[:20_000], 7)),
             ("no pair", (bits, uf[:0], vf[:0], chunk))]
    rows, pairs = 4097, 20_000
    for words in (1, 8, 33, 512):
        b = rng.integers(-2**31, 2**31, (rows, words), dtype=np.int64)
        b[rng.random((rows, words)) < 0.9] = 0
        b[:4] = rng.integers(1, 2**31, (4, words))
        b[0] = -1
        u = rng.integers(0, rows, pairs)
        u[:3000] = rng.integers(0, 4, 3000)        # runs on the hub rows
        u.sort()
        v = rng.integers(0, rows, pairs)
        bt, ut, vt = (torch.from_numpy(a.astype(np.int32)).to(dev)
                      for a in (b, u, v))
        sh = torch.from_numpy(rng.permutation(pairs)).to(dev)
        cases += [(f"words {words}, hub runs", (bt, ut, vt, 1000)),
                  (f"words {words}, shuffled", (bt, ut[sh], vt[sh], 1000))]
    return cases


def _check_non_decreasing(label: str, idx: torch.Tensor) -> None:
    """The sorted build's precondition, read back once: idx never
    decreases."""
    if idx.numel() > 1 and not bool((idx[1:] >= idx[:-1]).all()):
        raise AssertionError(f"{label}: the bitmap indices decrease")
    print(f"  {label}: {idx.numel()} bitmap indices, non-decreasing")


def _zero_fill_in_place_build(scm, u_blk, v_local, n_bits: int, words: int):
    """The triangle bitmap as the parent commit built it: a zero fill and
    the general kernel's in-place add (scatter_combine_)."""
    bits = torch.zeros(n_bits, dtype=torch.int32, device=u_blk.device)
    idx = u_blk * words + (v_local >> 5)
    bit = torch.bitwise_left_shift(torch.ones_like(v_local), v_local & 31)
    return scm.scatter_combine_(bits, idx, bit, "add")


def phase_slice6_kernels(scm, ap, ec, smi: str) -> dict:
    """scatter_combine's int32 add against its plain version, bit for bit,
    into 2^20 from 2^15, 2^16 and 2^17 messages (an eighth dropped), all
    dropped and none, then at the triangle count's shape (one column block
    of RMAT-18's oriented edges into its [v + 1, 512] bitmap), where the
    sorted build (scatter_combine_sorted, as _tc_build_bits runs it) is
    held to its plain version, the copying entry and the parent's zero fill
    + in-place add, and timed beside them; and_popcount against its plain
    version, bit for bit, on that block's presence-filtered edges, a ragged
    last chunk and an empty edge list. Returns the kernels' errors and
    times and the oriented edges (phase 12 counts triangles with them)."""
    from vectorgraphlibrary_tpu_torch.models import tc
    rng = np.random.default_rng(SEED + 6)
    dev = torch.device(DEVICE)
    v = 1 << 20

    def i32(n):
        return torch.from_numpy(rng.integers(-2**31, 2**31 - 1, n,
                                             dtype=np.int64)
                                .astype(np.int32)).to(dev)

    def exact(name, label, got, want) -> float:
        torch.cuda.synchronize()
        err = (got.double() - want.double()).abs().max().item() \
            if got.numel() else 0.0
        ok = got.dtype == want.dtype and torch.equal(got, want)
        print(f"  {name} {label}: {'bit-exact' if ok else 'MISMATCH'} "
              f"(max abs err {err})")
        if not ok:
            raise AssertionError(f"{name} != plain version: {label}")
        return err

    out = i32(v)
    cases = []
    for lg in (15, 16, 17):
        d = rng.integers(0, v, 1 << lg)
        d[rng.permutation(1 << lg)[:(1 << lg) // 8]] = v
        cases.append((f"add 2^{lg} -> 2^20", torch.from_numpy(
            d.astype(np.int32)).to(dev)))
    cases.append(("add, all dropped", torch.full((1 << 12,), v,
                                                 dtype=torch.int32, device=dev)))
    cases.append(("add, no message", torch.zeros(0, dtype=torch.int32,
                                                 device=dev)))
    sc_err = 0.0
    for label, idx in cases:
        msg = i32(idx.shape[0])
        sc_err = max(sc_err, exact(
            "scatter_combine", label, scm.scatter_combine(out, idx, msg, "add"),
            scm.scatter_combine_ref(out, idx, msg, "add")))
    idx = cases[1][1]
    msg = i32(idx.shape[0])
    keep = idx < v
    idx_in, msg_in = idx[keep].long(), msg[keep]
    add = dict(
        ms=_median3("scatter_combine add 2^16 -> 2^20, kernel", "ms",
                    [_cuda_ms(lambda: scm.scatter_combine(out, idx, msg, "add"))
                     for _ in range(3)], smi),
        plain_ms=_median3("scatter_combine add 2^16 -> 2^20, plain", "ms",
                          [_cuda_ms(lambda: scm.scatter_combine_ref(
                              out, idx, msg, "add")) for _ in range(3)], smi),
        library_ms=_median3("scatter_combine add 2^16 -> 2^20, index_add",
                            "ms", [_cuda_ms(lambda: torch.index_add(
                                out, 0, idx_in, msg_in)) for _ in range(3)],
                            smi),
        bound_ms=_bound_ms(8 * v + 4 * idx.shape[0] + 8 * idx_in.shape[0]))
    print(f"  scatter_combine add bound {add['bound_ms']:.4f} ms")

    # the triangle count's shapes: the column block with the most
    # presence-filtered edges, filtered on the card as
    # models/tc.vgl_triangle_count does
    t0 = time.perf_counter()
    u_e, v_e = tc._oriented_simple_edges(ec)
    host_s = time.perf_counter() - t0
    nv = ec.vertices_count
    block_bits = int(min(max(1 << 10, (1 << 32) // nv), 1 << 20))
    words = block_bits // 32
    ud, vd = torch.from_numpy(u_e).to(dev), torch.from_numpy(v_e).to(dev)
    pres = torch.zeros(nv + 1, dtype=torch.bool, device=dev)

    def block(c0):
        m = torch.nonzero((vd >= c0) & (vd < c0 + block_bits)).flatten()
        pres.zero_()
        pres[ud[m]] = True
        return m, torch.nonzero(pres[ud] & pres[vd]).flatten()

    sizes = []
    for c0 in range(0, nv, block_bits):
        m, em = block(c0)
        sizes.append((em.shape[0], c0, m.shape[0]))
    n_pairs, c0, n_build = max(sizes)
    m, em = block(c0)
    ub, vb = ud[m], vd[m] - c0
    uf, vf = ud[em], vd[em]
    print(f"  RMAT-{SCALE} triangle count: {len(u_e)} oriented edges "
          f"({host_s:.2f} s on the host), block_bits {block_bits} (words "
          f"{words}); the block at column {c0} builds {n_build} edges and "
          f"intersects {n_pairs} pairs")
    n_bits = (nv + 1) * words
    zeros = torch.zeros(n_bits, dtype=torch.int32, device=dev)
    flat_idx = ub * words + (vb >> 5)
    bit = torch.bitwise_left_shift(torch.ones_like(vb), vb & 31)
    bits = scm.scatter_combine(zeros, flat_idx, bit, "add")
    sc_err = max(sc_err, exact(
        "scatter_combine", f"add {n_build} bits -> [{nv + 1}, {words}]", bits,
        scm.scatter_combine_ref(zeros, flat_idx, bit, "add")))
    build = dict(
        ms=_median3("scatter_combine add, triangle bitmap, kernel", "ms",
                    [_cuda_ms(lambda: scm.scatter_combine(
                        zeros, flat_idx, bit, "add"), reps=3)
                     for _ in range(3)], smi),
        plain_ms=_median3("scatter_combine add, triangle bitmap, plain", "ms",
                          [_cuda_ms(lambda: scm.scatter_combine_ref(
                              zeros, flat_idx, bit, "add"), reps=3)
                           for _ in range(3)], smi),
        library_ms=_median3(
            "scatter_combine add, triangle bitmap, index_add", "ms",
            [_cuda_ms(lambda: torch.index_add(zeros, 0, flat_idx.long(), bit),
                      reps=3) for _ in range(3)], smi),
        # the bitmap read and its copy written, an index and a bit per edge
        bound_ms=_bound_ms(8 * n_bits + 8 * n_build))
    print(f"  scatter_combine add, triangle bitmap bound "
          f"{build['bound_ms']:.4f} ms")
    add["triangle_bitmap"] = build
    # the build as models/tc._tc_build_bits runs it: one launch of the
    # sorted build (scatter_combine_sorted), whose order idx must keep:
    # checked here once, outside the timed region (the kernel does not)
    _check_non_decreasing(f"the block at column {c0}", flat_idx)
    built = tc._tc_build_bits(ub, vb, nv, words).view(-1)
    sc_err = max(sc_err, exact(
        "scatter_combine_sorted", f"_tc_build_bits, {n_build} bits -> "
        f"[{nv + 1}, {words}]", built, bits))
    sorted_err = exact("scatter_combine_sorted", "plain version",
                       scm.scatter_combine_sorted(n_bits, flat_idx, bit,
                                                  "add"),
                       scm.scatter_combine_sorted_ref(n_bits, flat_idx, bit,
                                                      "add"))
    # the parent's design: a zero fill and the in-place add
    # (scatter_combine_), and its plain version in place
    parent = _zero_fill_in_place_build(scm, ub, vb, n_bits, words)
    sc_err = max(sc_err, exact("scatter_combine_", "zero fill + in-place "
                               "add", parent, built))
    plain_in_place = scm.scatter_combine_ref_(torch.zeros_like(zeros),
                                              flat_idx, bit, "add")
    sc_err = max(sc_err, exact("scatter_combine_", "plain version in place",
                               parent, plain_in_place))
    del built, parent, plain_in_place
    fidx = flat_idx.long()
    # in turns: the sorted build as the count runs it, its kernel alone,
    # the parent's design, torch.zeros + index_add_
    calls = {
        "tc_build_bits": lambda: tc._tc_build_bits(ub, vb, nv, words),
        "kernel": lambda: scm.scatter_combine_sorted(n_bits, flat_idx, bit,
                                                     "add"),
        "zero_fill_in_place_add": lambda: _zero_fill_in_place_build(
            scm, ub, vb, n_bits, words),
        "zeros_index_add_": lambda: torch.zeros(
            n_bits, dtype=torch.int32, device=dev).index_add_(0, fidx, bit)}
    runs = {k: [] for k in calls}
    for _ in range(3):
        for k, fn in calls.items():
            runs[k].append(_cuda_ms(fn, reps=3))
    label = f"triangle bitmap, {n_build} bits -> [{nv + 1}, {words}]"
    bms = {k: _median3(f"{label}, {k}", "ms", r, smi)
           for k, r in runs.items()}
    # the bound: the bitmap written once, an index and a bit per edge
    bound = _bound_ms(4 * n_bits + 8 * n_build)
    build_in_place = dict(ms=bms["zero_fill_in_place_add"],
                          library_ms=bms["zeros_index_add_"], bound_ms=bound)
    add["triangle_bitmap_in_place"] = build_in_place
    sorted_build = dict(
        max_err=sorted_err, ms=bms["kernel"], build_ms=bms["tc_build_bits"],
        zero_fill_in_place_add_ms=bms["zero_fill_in_place_add"],
        plain_ms=_median3(f"{label}, plain version", "ms", [_cuda_ms(
            lambda: scm.scatter_combine_sorted_ref(n_bits, flat_idx, bit,
                                                   "add"), reps=1)
            for _ in range(3)], smi),
        library_ms=bms["zeros_index_add_"], bound_ms=bound, bound_by="bytes",
        shape=label)
    print(f"  {label}: the sorted build {bms['kernel']:.4f} ms "
          f"(_tc_build_bits {bms['tc_build_bits']:.4f}), zero fill + "
          f"scatter_combine_ {bms['zero_fill_in_place_add']:.4f}, "
          f"torch.zeros + index_add_ {bms['zeros_index_add_']:.4f}; bound "
          f"{bound:.4f} ms on {smi}")
    del zeros, fidx

    bits = bits.view(nv + 1, words)
    chunk = 1 << 15
    pc_err = max(exact("and_popcount", label, ap.and_popcount(*args),
                       ap.and_popcount_ref(*args))
                 for label, args in _popcount_cases(bits, uf, vf, chunk, rng))
    k_ms = _median3(f"and_popcount {n_pairs} pairs x {words} words, kernel",
                    "ms", [_cuda_ms(lambda: ap.and_popcount(bits, uf, vf,
                                                            chunk), reps=3)
                           for _ in range(3)], smi)
    p_ms = _median3(f"and_popcount {n_pairs} pairs x {words} words, plain",
                    "ms", [_cuda_ms(lambda: ap.and_popcount_ref(
                        bits, uf, vf, chunk), reps=1) for _ in range(3)], smi)
    n_chunks = -(-n_pairs // chunk)
    # each input read once (the bitmap, both index lists), the chunk sums
    # written; the dense design's operations (an AND, a popcount and an add
    # per word of both rows) are printed for comparison only
    bytes_ms = _bound_ms(4 * n_bits + 8 * n_pairs + 4 * n_chunks)
    dense_ops_ms = 3 * n_pairs * words / OPS_PER_S * 1e3
    # the design's own floor: row u read once per run of equal u, one
    # 32-byte sector of row v per (pair, non-zero word of u), the index
    # lists and the sums
    nz_words = (bits != 0).sum(1, dtype=torch.int64)
    items = int(nz_words[uf.long()].sum())
    # what a design that walks the sparser of the two rows would need
    items_sparser = int(torch.minimum(nz_words[uf.long()],
                                      nz_words[vf.long()]).sum())
    runs = int((uf[1:] != uf[:-1]).sum()) + 1
    floor_ms = _bound_ms(4 * words * runs + 32 * items + 8 * n_pairs
                         + 4 * n_chunks)
    # the dense design's reads: both rows for every pair
    rows_ms = _bound_ms(8 * n_pairs * words + 8 * n_pairs)
    # an AND, a popcount and an add per item
    ops_ms = 3 * items / OPS_PER_S * 1e3
    print(f"  and_popcount bound {max(bytes_ms, ops_ms):.4f} ms (bytes "
          f"{bytes_ms:.4f}, operations {ops_ms:.4f}; the dense design's "
          f"{3 * n_pairs * words} operations would take "
          f"{dense_ops_ms:.4f}); design floor {floor_ms:.4f} ms ({runs} runs "
          f"of equal u, {items} (pair, non-zero word of u) items; "
          f"{items_sparser} on the sparser row of each pair); both rows read "
          f"per pair: {rows_ms:.4f} ms")
    del bits
    # one triangle count's launches: every column block with pairs, its
    # bitmap built as the count builds it
    per_block, builds, parent_builds, copy_builds = [], [], [], []
    for n_p, cb, _ in sizes:
        if n_p == 0:
            continue
        mb, eb = block(cb)
        ub_c, vb_c = ud[mb], vd[mb] - cb
        bidx = ub_c * words + (vb_c >> 5)
        _check_non_decreasing(f"the block at column {cb}", bidx)
        bb = tc._tc_build_bits(ub_c, vb_c, nv, words)
        ua, va = ud[eb], vd[eb]
        per_block.append(_cuda_ms(lambda: ap.and_popcount(bb, ua, va, chunk),
                                  reps=3))
        del bb
        # the build as the count runs it (the sorted build), as the parent
        # ran it (a zero fill and the in-place add) and as it ran with the
        # copying entry (a zero fill, the copy of it, the kernel), in turns,
        # three rounds, the median of each
        bbit = torch.bitwise_left_shift(torch.ones_like(vb_c), vb_c & 31)
        turns = [[], [], []]
        for _ in range(3):
            turns[0].append(_cuda_ms(lambda: tc._tc_build_bits(
                ub_c, vb_c, nv, words), reps=3))
            turns[1].append(_cuda_ms(lambda: _zero_fill_in_place_build(
                scm, ub_c, vb_c, n_bits, words), reps=3))
            turns[2].append(_cuda_ms(lambda: scm.scatter_combine(
                torch.zeros(n_bits, dtype=torch.int32, device=dev), bidx,
                bbit, "add"), reps=3))
        for got, t in zip((builds, parent_builds, copy_builds), turns):
            got.append(statistics.median(t))
    print(f"  and_popcount over one triangle count's {len(per_block)} "
          f"launches: {sum(per_block):.4f} ms (per block: "
          f"{', '.join(f'{t:.4f}' for t in per_block)}) on {smi}")
    print(f"  the count's {len(builds)} bitmap builds: {sum(builds):.4f} ms "
          f"by the sorted build, {sum(parent_builds):.4f} ms by a zero fill "
          f"+ scatter_combine_, {sum(copy_builds):.4f} ms with the copying "
          f"entry (per block, sorted / zero fill + scatter_combine_: "
          + ", ".join(f"{a:.4f} / {b:.4f}"
                      for a, b in zip(builds, parent_builds))
          + f") on {smi}")
    add["triangle_count_builds_ms"] = sum(builds)
    add["triangle_count_builds_zero_fill_in_place_ms"] = sum(parent_builds)
    add["triangle_count_builds_copying_ms"] = sum(copy_builds)
    sorted_build["per_triangle_count_ms"] = sum(builds)
    sorted_build["per_triangle_count_zero_fill_in_place_ms"] = sum(
        parent_builds)
    sorted_build["launches_per_triangle_count"] = len(builds)
    pc = dict(max_err=pc_err, ms=k_ms, plain_ms=p_ms, library_ms=None,
              bound_ms=max(bytes_ms, ops_ms),
              bound_by="bytes" if bytes_ms >= ops_ms else "operations",
              floor_ms=floor_ms,
              dense_design_operations=3 * n_pairs * words,
              row_reads_bound_ms=rows_ms, pairs=n_pairs, words=words,
              runs=runs, items=items, items_sparser_row=items_sparser,
              per_triangle_count_ms=sum(per_block),
              launches_per_triangle_count=len(per_block))
    return dict(scatter_err=sc_err, add=add, popcount=pc, oriented=(u_e, v_e),
                host_s=host_s, sorted=sorted_build)


def phase_slice6(kernels: dict, ec, graph, oriented, host_s: float,
                 smi: str) -> dict:
    """SCC, coloring, label propagation, random walks, reachability and the
    triangle count on the phase-4 RMAT-18 graph through the port's entry
    points, each checked against its oracle and its launch counts, with
    rates by bench.py's formulas (medians of 3); returns the kernels' launch
    counts over those calls."""
    from vectorgraphlibrary_tpu_torch.io import generation
    from vectorgraphlibrary_tpu_torch.models import (common, coloring, lp, rw,
                                                     scc, tc)
    from vectorgraphlibrary_tpu_torch.utils.verify import (
        equal_components, verify_colors, verify_results)
    totals = dict.fromkeys(kernels, 0)
    e = graph.e
    tag = f"RMAT-{SCALE}"

    def counted(label, fn, want):
        """fn() with the counts set to 0 just before and read just after;
        `want(out)` (or a dict) maps kernel names to the launches expected,
        0 if absent, or to a predicate on the count."""
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
        bad = {k: c for k, c in n.items()
               if not (expect[k](c) if callable(expect[k]) else c == expect[k])}
        if bad:
            raise AssertionError(f"{label}: launches {n}, expected {expect}")
        return out

    def check(label, errors):
        if errors:
            raise AssertionError(f"{label}: error count {errors}")

    def rate(label, fn, work, extra_s: float = 0.0):
        times = _timed3(fn)
        print(f"  {label} s per call: {', '.join(f'{t:.5f}' for t in times)}")
        return _median3(f"{label} {tag} MTEPS", "MTEPS",
                        [work / (extra_s + t) / 1e6 for t in times], smi)

    rates = {}
    torch.cuda.reset_peak_memory_stats()
    # SCC: 2 pulls and 4 routes per trim round, 1 pull and 2 routes per hop
    trace = []
    labels = counted(
        "vgl_forward_backward", lambda: scc.vgl_forward_backward(
            graph, trace=trace),
        lambda out: dict(
            pull_reduce=2 * sum(k == "trim" for k, _ in trace)
            + sum(n for k, n in trace if k == "flood"),
            route_gather_finish=4 * sum(k == "trim" for k, _ in trace)
            + 2 * sum(n for k, n in trace if k == "flood")))
    pivots = [n for k, n in trace if k == "pivot"]
    print(f"    trim rounds {[n for k, n in trace if k == 'trim']}, flood "
          f"hops {[n for k, n in trace if k == 'flood']}, {len(pivots)} "
          f"pivots")
    want_scc = scc.seq_scc(ec)
    print(f"    {len(np.unique(want_scc))} components (seq_scc)")
    check("SCC", equal_components(labels.values[:graph.v].cpu().numpy(),
                                  want_scc))
    rates["scc"] = rate("SCC", lambda: scc.vgl_forward_backward(graph), e)

    # coloring with core extraction: 10 pulls and 20 routes per round
    colors, rounds = counted(
        "vgl_coloring(ec=...)", lambda: coloring.vgl_coloring(graph, ec=ec),
        lambda out: dict(pull_reduce=10 * out[1],
                         route_gather_finish=20 * out[1]))
    vals = colors.values[:graph.v].cpu().numpy()
    print(f"    {rounds} rounds, {int(vals.max()) + 1} colors")
    check("coloring", verify_colors(ec, vals))
    t0 = time.perf_counter()
    core = coloring.host_core_colors(ec, 256)
    core_s = time.perf_counter() - t0
    print(f"    host core pass {core_s:.4f} s ({int((core >= 0).sum())} core "
          f"vertices)")
    rates["coloring"] = rate("coloring (core s + device s)",
                             lambda: coloring.vgl_coloring(
                                 graph, core_colors=core), e, core_s)
    rates["coloring_rounds"] = rounds

    # label propagation: gathers and sorts, no kernel
    (lp_labels, lp_iters) = counted(
        "vgl_label_propagation(max_iterations=10)",
        lambda: lp.vgl_label_propagation(graph, max_iterations=10), {})
    print(f"    {lp_iters} rounds")
    t0 = time.perf_counter()
    want_lp = lp.seq_label_propagation_fast(ec, max_iterations=10)
    print(f"    seq_label_propagation (vectorised) {time.perf_counter() - t0:.2f}"
          f" s on the host")
    check("LP", verify_results(lp_labels.values[:graph.v].cpu().numpy(),
                               want_lp))
    rates["lp"] = rate("LP", lambda: lp.vgl_label_propagation(
        graph, max_iterations=10), e)

    # random walks: gathers, no kernel
    src = common.select_random_source(ec, seed=SEED)
    walkers = np.full(1024, src, np.int64)
    finals, paths = counted(
        "vgl_random_walk 1024 walkers x 10 steps",
        lambda: rw.vgl_random_walk(graph, walkers, walk_length=10, seed=SEED,
                                   store_walk_paths=True), {})
    nv = ec.vertices_count
    keys = np.unique(ec.src_ids.astype(np.int64) * nv + ec.dst_ids)
    outdeg = np.bincount(ec.src_ids, minlength=nv)
    steps = paths[:, :-1].astype(np.int64) * nv + paths[:, 1:]
    on_edge = np.isin(steps, keys) | ((paths[:, :-1] == paths[:, 1:])
                                      & (outdeg[paths[:, :-1]] == 0))
    reach = rw.seq_random_walk_reachable(ec, src, 10)
    bad = int((~on_edge).sum()) + int((~reach[finals]).sum())
    print(f"    source {src}: {len(np.unique(finals))} distinct ends, "
          f"violations {bad}")
    check("RW", bad)

    # reachability from 2 sources: the SCC pulls, then one push_expand per
    # BFS level
    sources = np.asarray(_sssp_sources(ec))
    want_r = tc.seq_reachability(ec, sources)
    # Purdom: the SCC's pulls and routes, then on the condensed graph one
    # push per BFS level and one route per source; BFS-based: the same on
    # the graph itself
    for label, fn, want in (
            ("reachability (Purdom)",
             lambda: tc.reachability(ec, graph, sources),
             dict(push_expand=lambda c: c >= len(sources),
                  pull_reduce=lambda c: c > 0,
                  route_gather_finish=lambda c: c > len(sources))),
            ("vgl_bfs_based_reachability",
             lambda: tc.vgl_bfs_based_reachability(graph, sources),
             dict(push_expand=lambda c: c >= len(sources),
                  route_gather_finish=len(sources)))):
        got = counted(f"{label} sources {sources.tolist()}", fn, want)
        print(f"    {int(got.sum())} of {got.size} reached")
        check(label, int((got != want_r).sum()))
    print(f"  slice peak device memory before the triangle count "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB on {smi}")

    # triangle count: one bitmap scatter and one AND-popcount per block
    torch.cuda.reset_peak_memory_stats()
    ttrace = []
    tris = counted(
        "vgl_triangle_count", lambda: tc.vgl_triangle_count(
            ec, _oriented=oriented, device=DEVICE, trace=ttrace),
        lambda out: dict(
            scatter_combine=sum(t is not None for t in ttrace),
            scatter_combine_sorted=sum(t is not None for t in ttrace),
            and_popcount=sum(t is not None for t in ttrace)))
    blocks = [t for t in ttrace if t is not None]
    print(f"    {tris} triangles; {len(blocks)} of {len(ttrace)} blocks, "
          f"{sum(t[2] for t in blocks)} pairs, presence filter on the card "
          f"{sum(t[3] for t in blocks):.4f} s, bitmaps and AND-popcounts "
          f"{sum(t[4] for t in blocks):.4f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    if tris != TRIANGLES_RMAT18 and SCALE == 18:
        raise AssertionError(f"triangles {tris}, expected {TRIANGLES_RMAT18}")
    t0 = time.perf_counter()
    want_t = tc.seq_oriented_triangle_count(*oriented, ec.vertices_count)
    print(f"    host oracle (A+ . A+) o A+: {want_t} in "
          f"{time.perf_counter() - t0:.2f} s")
    check("triangle count", abs(tris - want_t))
    rates["triangles"] = rate(
        "triangles (host orientation s + device s)",
        lambda: tc.vgl_triangle_count(ec, _oriented=oriented, device=DEVICE),
        e, host_s)
    ec14 = generation.rmat(14, DEGREE, seed=SEED, weighted=False)
    t14 = tc.vgl_triangle_count(ec14, block_bits=256, device=DEVICE)
    w14 = tc.seq_triangle_count(ec14)
    print(f"  RMAT-14 block_bits 256: {t14} triangles, seq_triangle_count "
          f"{w14}")
    check("triangle count RMAT-14", abs(t14 - w14))
    return dict(launches=totals, rates=rates, core=core)


# GraphSAGE at the widths of OGB's ogbn-products GraphSAGE baseline (100
# input features, hidden 256, 47 classes; Hu et al. 2020), on RMAT-20 in
# place of its 2,449,029-vertex graph, which cannot be downloaded; the
# sampled steps take GraphSAGE's fan-outs S1 = 25, S2 = 10 (Hamilton et al.
# 2017) on RMAT-18
SAGE_IN, SAGE_HIDDEN, SAGE_CLASSES = 100, 256, 47
SAGE_STEPS, SAGE_SAMPLED_STEPS, SAGE_FANOUT = 5, 3, (25, 10)
SAGE_LR = 1e-3                  # Adam
REPLACES_ROWS = ("none: vectorgraphlibrary_tpu/models/gnn.py:29 "
                 "(aggregate_sum_count) runs outside Pallas")
REPLACES_SEGMENT = ("none: vectorgraphlibrary_tpu/ops/advance.py:82 "
                    "(_advance_pull_csr) runs outside Pallas")
INT32_MAX = 2**31 - 1


def _counted(kernels: dict, totals: dict, label: str, fn, want: dict):
    """fn() with every count set to 0 just before and read just after; the
    counts must equal `want` (kernel name -> launches, 0 if absent); they
    are added to totals."""
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


def _rows_check(prw, label: str, csr, x) -> float:
    """pull_rows against its plain version on the same inputs, run in f64:
    within rtol 1e-5 / atol 1e-6 (an f32 sum in any order drifts by about
    that much over RMAT-20's longest rows; the f32 plain version's own error
    is printed), two runs bit-identical, and integer-valued rows bit for bit
    against the f32 plain version. Returns the max abs error."""
    row_ptr, col_idx = csr.row_ptr, csr.col_idx
    got = prw.pull_rows(csr, x)
    again = prw.pull_rows(csr, x)
    want = prw.pull_rows_ref(row_ptr, col_idx, x.double())
    plain32 = prw.pull_rows_ref(row_ptr, col_idx, x)
    torch.cuda.synchronize()
    err = (got.double() - want).abs().max().item()
    err32 = (plain32.double() - want).abs().max().item()
    same = torch.equal(got.view(torch.int32), again.view(torch.int32))
    close = bool(torch.isclose(got.double(), want, rtol=1e-5,
                               atol=1e-6).all())
    xi = torch.floor(x * 16)
    exact = torch.equal(prw.pull_rows(csr, xi),
                        prw.pull_rows_ref(row_ptr, col_idx, xi))
    print(f"  pull_rows {label}: {'within rtol 1e-5' if close else 'MISMATCH'}"
          f" of the f64 plain version (max abs err {err}; the f32 plain "
          f"version's {err32}), two runs "
          f"{'bit-identical' if same else 'DIFFER'}, integer-valued rows "
          f"{'bit-exact' if exact else 'MISMATCH'}")
    if not (close and same and exact):
        raise AssertionError(f"pull_rows != plain version: {label}")
    return err


def _rows_times(prw, label: str, csr, x, e: int, smi: str) -> dict:
    """Kernel, f32 plain version and torch.sparse.mm of the CSR with ones
    (the one-call yardstick), medians of 3 by events; the bound (row_ptr,
    col_idx, x read once, out written once), the all-DRAM floor (each
    edge's row from device memory), the kernel's lanes and the share of
    edges whose row it reads under L2's evict_last."""
    row_ptr, col_idx = csr.row_ptr, csr.col_idx
    n, f = row_ptr.shape[0] - 1, x.shape[1]
    k_ms = _median3(f"pull_rows {label}, kernel", "ms", [_cuda_ms(
        lambda: prw.pull_rows(csr, x)) for _ in range(3)], smi)
    p_ms = _median3(f"pull_rows {label}, plain", "ms", [_cuda_ms(
        lambda: prw.pull_rows_ref(row_ptr, col_idx, x), reps=2)
        for _ in range(3)], smi)
    a = torch.sparse_csr_tensor(row_ptr, col_idx[:e],
                                torch.ones(e, device=x.device),
                                size=(n, x.shape[0]))
    lib = _median3(f"pull_rows {label}, torch.sparse.mm", "ms", [_cuda_ms(
        lambda: torch.sparse.mm(a, x)) for _ in range(3)], smi)
    lib_err = (torch.sparse.mm(a, x).double() - prw.pull_rows_ref(
        row_ptr, col_idx, x.double())).abs().max().item()
    bound = _bound_ms((n + 1) * 4 + e * 4 + x.shape[0] * f * 4 + n * f * 4)
    floor = _bound_ms(e * f * 4)
    vec, cv, n_chunks = prw.lanes(f, x.data_ptr() | 4 * f)
    hot = float((col_idx[:e] < prw.L2_LAST_ROWS).sum()) / e
    print(f"  pull_rows {label}: bound {bound:.4f} ms, every edge's row "
          f"from device memory {floor:.4f} ms; torch.sparse.mm's max abs err "
          f"{lib_err}; {vec} floats per lane, chunks of {cv * vec} floats "
          f"({n_chunks}); columns below {prw.L2_LAST_ROWS} (L2 evict_last): "
          f"{100 * hot:.1f} % of the edges")
    return dict(ms=k_ms, plain_ms=p_ms, library_ms=lib, bound_ms=bound,
                floor_ms=floor, chunk_floats=cv * vec, floats_per_lane=vec,
                l2_last_rows=prw.L2_LAST_ROWS, l2_last_edge_share=hot)


def phase_sage(kernels: dict, prw, ec, graph, small_graph, smi: str) -> dict:
    """GraphSAGE at ogbn-products' widths on RMAT-20 (full aggregation) and
    RMAT-18 (sampled), through the port's entry points, with pull_rows and
    its backward against their plain versions at the path's shapes; returns
    the kernels' launch counts over the training steps, errors and times."""
    from vectorgraphlibrary_tpu_torch.models import gnn
    totals = dict.fromkeys(kernels, 0)
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 13)
    dg = graph.incoming
    v_pad, e = graph.v_pad, dg.e
    csr = prw.RowCSR(dg.row_ptr, dg.col_idx)
    print(f"  RMAT-{BFS_SCALE} GATHER CSR: {e} edges, largest in-degree "
          f"{int(dg.degrees.max())}, {csr.hubs.numel()} rows of more than "
          f"{prw.HUB_MIN} edges (a block each)")
    feats = torch.rand((v_pad, SAGE_IN), generator=gen, device=dev)
    h = torch.rand((v_pad, SAGE_HIDDEN), generator=gen, device=dev)
    err = max(_rows_check(prw, f"F = {SAGE_IN}", csr, feats),
              _rows_check(prw, f"F = {SAGE_HIDDEN}", csr, h))
    t0 = time.perf_counter()
    csr_t = prw.RowCSR(*gnn.transposed_csr(dg))
    torch.cuda.synchronize()
    print(f"  transposed CSR (the backward's): {time.perf_counter() - t0:.4f}"
          f" s, {csr_t.hubs.numel()} hub rows")
    err = max(err, _rows_check(prw, f"backward F = {SAGE_HIDDEN}", csr_t, h))
    times = {f"f{SAGE_IN}": _rows_times(prw, f"F = {SAGE_IN}", csr, feats, e,
                                        smi),
             f"f{SAGE_HIDDEN}": _rows_times(prw, f"F = {SAGE_HIDDEN}", csr, h,
                                            e, smi),
             f"backward_f{SAGE_HIDDEN}": _rows_times(
                 prw, f"backward F = {SAGE_HIDDEN}", csr_t, h, e, smi)}
    del h

    # aggregate_mean against the oracle, in original ids
    o2s = graph.incoming.orig_to_sorted[:graph.v].long()
    mean = gnn.aggregate_mean(graph, feats)[o2s].cpu().numpy()
    t0 = time.perf_counter()
    want = gnn.seq_aggregate_mean(ec, feats[o2s].cpu().numpy())
    ok = np.allclose(mean, want, rtol=1e-5, atol=1e-6)
    print(f"  aggregate_mean against seq_aggregate_mean "
          f"({time.perf_counter() - t0:.2f} s on the host): "
          f"{'within rtol 1e-5' if ok else 'MISMATCH'} (max abs err "
          f"{np.abs(mean - want).max()})")
    if not ok:
        raise AssertionError("aggregate_mean != seq_aggregate_mean")

    # full-aggregation training steps
    labels = torch.randint(0, SAGE_CLASSES, (v_pad,), generator=gen,
                           device=dev)
    mask = torch.arange(v_pad, device=dev) < graph.v
    params = gnn.init_sage(torch.Generator(device=DEVICE).manual_seed(SEED),
                           SAGE_IN, SAGE_HIDDEN, SAGE_CLASSES)
    step = gnn.make_train_step(graph, torch.optim.Adam(params.parameters(),
                                                       lr=SAGE_LR))
    torch.cuda.reset_peak_memory_stats()
    losses = [float(_counted(
        kernels, totals, f"full-aggregation step {i}",
        lambda: step(params, feats, labels, mask), dict(pull_rows=3)))
        for i in range(SAGE_STEPS)]
    peak = torch.cuda.max_memory_allocated()
    print(f"  losses {losses}; peak device memory {peak / 2**20:.1f} MiB")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"the full-aggregation loss did not fall: "
                             f"{losses}")
    step_ms = _median3(f"full-aggregation step RMAT-{BFS_SCALE}", "ms",
                       [_cuda_ms(lambda: step(params, feats, labels, mask),
                                 reps=1) for _ in range(3)], smi)

    # sampled steps on RMAT-18
    sg = small_graph
    sfeats = torch.rand((sg.v_pad, SAGE_IN), generator=gen, device=dev)
    slabels = torch.randint(0, SAGE_CLASSES, (sg.v_pad,), generator=gen,
                            device=dev)
    smask = torch.arange(sg.v_pad, device=dev) < sg.v
    s1, s2 = (gnn.sample_neighbors(sg, k, gen) for k in SAGE_FANOUT)
    for s, k in ((s1, SAGE_FANOUT[0]), (s2, SAGE_FANOUT[1])):
        if s.shape != (sg.v_pad, k) or not bool(
                ((s >= 0) & (s < sg.v_pad)).all()):
            raise AssertionError(f"the sample of {k} is not [v_pad, {k}] of "
                                 f"vertex ids")
    sparams = gnn.init_sage(
        torch.Generator(device=DEVICE).manual_seed(SEED + 1), SAGE_IN,
        SAGE_HIDDEN, SAGE_CLASSES)
    sstep = gnn.make_train_step(sg, torch.optim.Adam(sparams.parameters(),
                                                     lr=SAGE_LR))
    torch.cuda.reset_peak_memory_stats()
    slosses = [float(_counted(
        kernels, totals, f"sampled step {i} (k = {SAGE_FANOUT})",
        lambda: sstep(sparams, sfeats, slabels, smask, s1, s2), {}))
        for i in range(SAGE_SAMPLED_STEPS)]
    speak = torch.cuda.max_memory_allocated()
    print(f"  sampled losses {slosses}; peak device memory "
          f"{speak / 2**20:.1f} MiB")
    if not all(np.isfinite(slosses)):
        raise AssertionError(f"sampled losses are not finite: {slosses}")
    sstep_ms = _median3(f"sampled step RMAT-{SCALE}", "ms", [_cuda_ms(
        lambda: sstep(sparams, sfeats, slabels, smask, s1, s2), reps=1)
        for _ in range(3)], smi)
    return dict(launches=totals, max_err=err, times=times,
                step_ms=step_ms, sampled_step_ms=sstep_ms,
                peak_mib=peak / 2**20, sampled_peak_mib=speak / 2**20,
                losses=losses, sampled_losses=slosses)


def _advance_plain(pl, dg, msg, src_active, op):
    """The general advance's plain version on one direction: the messages
    (one per CSR slot) of inactive sources set to the identity, then the
    segment-reduce entry's plain version."""
    from vectorgraphlibrary_tpu_torch.ops import monoid as M
    if src_active is not None:
        msg = torch.where(src_active[dg.col_idx[:dg.e].long()], msg,
                          M.get(op).identity(msg.dtype).to(msg.device))
    return pl.segment_reduce_ref(dg.row_ptr, msg, op)


def phase_mf(kernels: dict, pl, ec, smi: str) -> dict:
    """Max-flow on the phase-4 RMAT-18 graph, prepared as apps/mf.py
    prepares it, on two (source, sink) pairs as the app picks them, through
    the port's entry points; the general advance and the segment-reduce
    entry against their plain versions on its residual graph. Returns the
    kernels' launch counts, errors, times and rates."""
    from vectorgraphlibrary_tpu_torch.apps import mf as mf_app
    from vectorgraphlibrary_tpu_torch.graph.edges import DirectedEdgeValues
    from vectorgraphlibrary_tpu_torch.models import bfs, common, mf
    from vectorgraphlibrary_tpu_torch.ops.advance import (advance_pull,
                                                          pull_plan)
    totals = dict.fromkeys(kernels, 0)
    t0 = time.perf_counter()
    ec2 = mf_app.prepare(ec, SEED)
    g2, res0 = mf.build_residual(ec2, DEVICE)[:2]
    torch.cuda.synchronize()
    print(f"  RMAT-{SCALE} without self-loops and duplicates: "
          f"{ec2.edges_count} edges, capacities in [1, 100); residual graph "
          f"of {g2.e} arcs built in {time.perf_counter() - t0:.2f} s")
    rates, flows = [], []
    for it in range(2):
        src = common.select_random_source(ec, seed=SEED + it)
        sink = mf_app.sink_for(ec2, src)
        trace = []
        flow = _counted(
            kernels, totals, f"vgl_ford_fulkerson {src} -> {sink}",
            lambda: mf.vgl_ford_fulkerson(ec2, None, src, sink, device=DEVICE,
                                          trace=trace),
            lambda out: dict(pull_reduce=sum(t[0] for t in trace)))
        t0 = time.perf_counter()
        want = mf.seq_ford_fulkerson(ec2, src, sink)
        print(f"    flow {flow} ({len(trace) - 1} augmentations, "
              f"{sum(t[0] for t in trace)} BFS levels, the longest path "
              f"{max(t[1] for t in trace)} arcs); seq_ford_fulkerson {want} "
              f"({time.perf_counter() - t0:.2f} s on the host)")
        if flow != want or not flow > 0:
            raise AssertionError(f"max-flow {src} -> {sink}: {flow}, "
                                 f"expected {want} > 0")
        flows.append(flow)
        times = _timed3(lambda: mf.vgl_ford_fulkerson(ec2, None, src, sink,
                                                      device=DEVICE))
        print(f"    s per call: {', '.join(f'{t:.5f}' for t in times)}")
        rates.append(_median3(f"max-flow {src} -> {sink} RMAT-{SCALE} MTEPS "
                              f"(|E| / t, apps/mf.py's)", "MTEPS",
                              [ec.edges_count / t / 1e6 for t in times], smi))

    src = common.select_random_source(ec, seed=SEED)
    zero = np.zeros(ec2.edges_count, np.float32)
    lv = _counted(kernels, totals, "vgl_mf_bfs_levels, zero flow",
                  lambda: mf.vgl_mf_bfs_levels(ec2, None, zero, src,
                                               device=DEVICE),
                  lambda out: dict(segment_reduce=int(
                      out[out < INT32_MAX].max())))
    seq = bfs.seq_top_down(ec2, src)
    if not np.array_equal(lv, np.where(seq < 0, INT32_MAX, seq)):
        raise AssertionError("vgl_mf_bfs_levels with zero flow != "
                             "seq_top_down's levels")
    print(f"    levels equal seq_top_down's ({int((seq > 0).sum())} "
          f"reached, {int(seq.max())} levels)")

    # the general advance and the segment-reduce entry on the residual
    # graph's GATHER CSR, against their plain versions
    dg = g2.incoming
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 14)
    dev = torch.device(DEVICE)
    iota = torch.arange(dg.e_pad, dtype=torch.int32, device=dev)
    w = torch.where(res0 > mf._EPS, iota, mf._BIG)
    on = torch.rand(g2.v_pad, generator=gen, device=dev) < 0.3
    # the BFS level's pull as vgl_ford_fulkerson launches it: i32 min of
    # max(x, w), x 0 at the level's sources and the min's identity at the
    # others (advance_pull_value's mask), with 30 % and all sources active
    label = f"RMAT-{SCALE} residual G i32 min of max(x, w)"
    x_lvl = torch.where(on, 0, INT32_MAX).to(torch.int32)
    pull_err = max(
        _pull_check(pl, f"{label}, 30 % active", dg, x_lvl, "min", False, w,
                    "max"),
        _pull_check(pl, f"{label}, all active", dg, torch.zeros_like(x_lvl),
                    "min", False, w, "max"))
    pull = _pull_times(pl, dg, x_lvl, "min", False, f"{label}, 30 % active",
                       smi, weights=w, weight_op="max")
    pull.update(max_err=pull_err, library_ms=None)
    x = torch.rand(g2.v_pad, generator=gen, device=dev)
    cols = dg.col_idx[:dg.e].long()
    rows = torch.repeat_interleave(torch.arange(g2.v_pad, device=dev),
                                   dg.degrees.long(), output_size=dg.e)
    err = 0.0
    cases = (("min of the arc id (the BFS's)", "min", {},
              lambda s, d, ww: ww, w[:dg.e], on),
             ("max of x[src] + x[dst]", "max", {"x": x},
              lambda s, d, ww: s["x"] + d["x"], x[cols] + x[rows], on),
             ("add of x[src] * res", "add", {"x": x},
              lambda s, d, ww: s["x"] * ww, x[cols] * res0[:dg.e], None))
    for label, op, arrs, edge_op, msg, act in cases:
        vals = res0 if op == "add" else w
        got = advance_pull(g2, arrs, edge_op, op, dst_arrays=arrs,
                           edge_values=DirectedEdgeValues(flat=vals),
                           src_active=act)
        want = _advance_plain(pl, dg, msg, act, op)
        torch.cuda.synchronize()
        ok = (bool(torch.isclose(got, want, rtol=1e-5, atol=1e-6).all())
              if op == "add" else torch.equal(got, want))
        e_ = torch.where(got == want, 0.0,
                         (got.double() - want.double()).abs()).max().item()
        err = max(err, e_)
        print(f"  advance_pull {label}: "
              f"{('within rtol 1e-5' if op == 'add' else 'exact') if ok else 'MISMATCH'}"
              f" (max abs err {e_})")
        if not ok:
            raise AssertionError(f"advance_pull != plain version: {label}")
    plan = pull_plan(dg)
    mi = torch.where(on[cols], w[:dg.e], INT32_MAX).contiguous()
    mf32 = torch.rand(dg.e_pad, generator=gen, device=dev)
    mb = (torch.rand(dg.e_pad, generator=gen, device=dev) < 0.1).to(
        torch.int8)
    for label, m, op in (("i32 min", mi, "min"), ("f32 add", mf32, "add"),
                         ("f32 max", mf32, "max"), ("i8 any01", mb, "any01")):
        got = pl.segment_reduce(dg.row_ptr, m, op, plan)
        want = pl.segment_reduce_ref(dg.row_ptr, m, op)
        torch.cuda.synchronize()
        ok = (bool(torch.isclose(got, want, rtol=1e-5, atol=1e-6).all())
              if op == "add" else torch.equal(got, want))
        # equal entries (an empty row's identity, inf or not) count as 0
        e_ = torch.where(got == want, 0.0,
                         (got.double() - want.double()).abs()).max().item()
        err = max(err, e_)
        print(f"  segment_reduce {label}: "
              f"{('within rtol 1e-5' if op == 'add' else 'exact') if ok else 'MISMATCH'}"
              f" (max abs err {e_})")
        if not ok:
            raise AssertionError(f"segment_reduce != plain version: {label}")
    label = f"i32 min over the RMAT-{SCALE} residual CSR ({dg.e} slots)"
    k_ms = _median3(f"segment_reduce {label}, kernel", "ms", [_cuda_ms(
        lambda: pl.segment_reduce(dg.row_ptr, mi, "min", plan))
        for _ in range(3)], smi)
    p_ms = _median3(f"segment_reduce {label}, plain", "ms", [_cuda_ms(
        lambda: pl.segment_reduce_ref(dg.row_ptr, mi, "min"))
        for _ in range(3)], smi)
    # one PyTorch call with the slots' row ids given: scatter_reduce
    base = torch.full((g2.v_pad,), INT32_MAX, dtype=torch.int32, device=dev)
    lib = _median3(f"segment_reduce {label}, scatter_reduce by row id", "ms",
                   [_cuda_ms(lambda: base.scatter_reduce(
                       0, rows, mi[:dg.e], "amin")) for _ in range(3)], smi)
    lengths = dg.degrees.long()
    f32_lib = _median3(
        f"segment_reduce f32 add ({dg.e} slots), torch.segment_reduce", "ms",
        [_cuda_ms(lambda: torch.segment_reduce(
            mf32[:dg.e], "sum", lengths=lengths, unsafe=True))
         for _ in range(3)], smi)
    f32_ms = _median3(f"segment_reduce f32 add ({dg.e} slots), kernel", "ms",
                      [_cuda_ms(lambda: pl.segment_reduce(
                          dg.row_ptr, mf32, "add", plan))
                       for _ in range(3)], smi)
    # bytes it must move: row_ptr, the slots' messages, out
    bound = _bound_ms((g2.v_pad + 1) * 4 + dg.e * 4 + g2.v_pad * 4)
    print(f"  segment_reduce bound {bound:.4f} ms ({plan.n_tiles} tiles, "
          f"{plan.n_fix} rows cut)")
    return dict(launches=totals, max_err=err, ms=k_ms, plain_ms=p_ms,
                library_ms=lib, bound_ms=bound, f32_add_ms=f32_ms,
                f32_add_library_ms=f32_lib, rates=rates, flows=flows,
                pull=pull)


def _k4_retime(scm, smi: str) -> dict:
    """K4's row under the launch path of build.Launcher: scatter_combine's
    int32 min of 2^16 messages (an eighth dropped) into 2^20, as phase 5
    times it, beside scatter_reduce and index_add of the messages that land;
    the int32 add the same way; and the in-place entry scatter_combine_
    (min and add, into a target of its own) beside index_add_; in turns,
    means of 100 launches by events, medians of 3, and each on the device by
    torch.profiler. The in-place calls combine into the same target again
    and again, which changes its values but not the work. Two bounds: the
    copying entry's reads and writes the whole target; the in-place
    entry's only the 32-byte sectors of it that the landing messages
    touch, each read and written once."""
    rng = np.random.default_rng(SEED)
    v = 1 << 20
    dev = torch.device(DEVICE)

    def i32(n):
        return torch.from_numpy(rng.integers(-2**31, 2**31 - 1, n,
                                             dtype=np.int64)
                                .astype(np.int32)).to(dev)
    out = i32(v)
    d = rng.integers(0, v, 1 << 16)
    d[rng.permutation(1 << 16)[:(1 << 16) // 8]] = v
    idx = torch.from_numpy(d.astype(np.int32)).to(dev)
    msg = i32(1 << 16)
    keep = idx < v
    idx_in, msg_in = idx[keep].long(), msg[keep]
    t_min, t_add, t_lib = out.clone(), out.clone(), out.clone()
    # the in-place entry equals the copying one and the plain version
    for op, t in (("min", t_min), ("add", t_add)):
        got = scm.scatter_combine_(t, idx, msg, op)
        want = scm.scatter_combine_ref(out, idx, msg, op)
        torch.cuda.synchronize()
        if got is not t or not torch.equal(got, want) or not torch.equal(
                got, scm.scatter_combine(out, idx, msg, op)):
            raise AssertionError(f"scatter_combine_ {op} != plain version")
        print(f"  scatter_combine_ (in place) int32 {op} 2^16 -> 2^20: "
              f"bit-exact against the plain version and the copying entry")
    calls = {"kernel": lambda: scm.scatter_combine(out, idx, msg, "min"),
             "scatter_reduce": lambda: torch.scatter_reduce(
                 out, 0, idx_in, msg_in, "amin"),
             "index_add": lambda: torch.index_add(out, 0, idx_in, msg_in),
             "kernel_add": lambda: scm.scatter_combine(out, idx, msg, "add"),
             "kernel_in_place_min": lambda: scm.scatter_combine_(
                 t_min, idx, msg, "min"),
             "kernel_in_place_add": lambda: scm.scatter_combine_(
                 t_add, idx, msg, "add"),
             "index_add_": lambda: t_lib.index_add_(0, idx_in, msg_in)}
    runs = {k: [] for k in calls}
    for _ in range(3):
        for k, fn in calls.items():
            runs[k].append(_cuda_ms(fn, reps=100))
    label = "scatter_combine int32 2^16 -> 2^20 (K4's row, again)"
    ms = {k: _median3(f"{label}, {k}", "ms", r, smi) for k, r in runs.items()}
    ms["plain"] = _median3(f"{label}, plain", "ms", [_cuda_ms(
        lambda: scm.scatter_combine_ref(out, idx, msg, "min"))
        for _ in range(3)], smi)
    device = {k: _profiled_ms(fn)["total"] for k, fn in calls.items()}
    msg_bytes = 4 * idx.shape[0] + 4 * idx_in.shape[0]
    bound = _bound_ms(8 * v + msg_bytes)
    sectors = torch.unique(idx_in >> 3).numel()
    bound_in_place = _bound_ms(2 * 32 * sectors + msg_bytes)
    print(f"  {label}: device ms per call by torch.profiler {device}, bound "
          f"{bound:.4f} ms copying, {bound_in_place:.4f} ms in place "
          f"({sectors} sectors of the target touched) on {smi}")
    steps = _k4_launch_steps(smi)
    return dict(events_ms=ms, device_ms=device, bound_ms=bound,
                bound_in_place_ms=bound_in_place,
                sectors_touched=sectors, in_place_add_steps=steps)


def _k4_launch_steps(smi: str) -> dict:
    """The in-place int32 add of 2^16 messages into 2^20 step by step, as
    _launch_cost does for the route (apps/exp_scatter.steps: the wrapper,
    index_add_ and Monoid.scatter_at_ in turns, then each step of the
    launch alone), and the wrapper and the route's smallest launch through
    a ctypes.CDLL and a ctypes.PyDLL handle of the library in turns
    (apps/exp_scatter.handles). Ms per call by CUDA events; where a step
    launches nothing, that is host time."""
    from vectorgraphlibrary_tpu_torch.apps import exp_scatter
    label = "in-place int32 add 2^16 -> 2^20"
    ms = exp_scatter.steps()
    handles = exp_scatter.handles()
    print(f"  {label}: wrapper {ms['wrapper']:.4f} ms by events, index_add_ "
          f"{ms['index_add_']:.4f}, Monoid.scatter_at_ "
          f"{ms['monoid_scatter_at_']:.4f}; the launch without the checks "
          f"{ms['launcher']:.4f} (medians of 7 rounds of 300 calls in turns) "
          f"on {smi}")
    print(f"  {label}, steps by events (ms): {json.dumps(ms)}")
    print(f"  ctypes handle, ms per call by events in turns (CDLL against "
          f"PyDLL, 7 rounds of 300 calls): {json.dumps(handles)} on {smi}")
    return dict(events_ms=ms, handles_ms=handles)


def profile(pl, pr_graph, bfs_graph, bfs_root, ec, ea, pr_ec, oriented, core,
            out_dir: str) -> None:
    """Device time by kernel of one call of each slice, beside its wall time
    without the profiler, to DIR/<slice>_profile.txt and the output. A
    window in which the profiler recorded fewer pull_reduce kernels than
    the wrapper launched is taken again (three times at most) and marked
    INCOMPLETE if it stays short."""
    from vectorgraphlibrary_tpu_torch.models import (bfs, coloring, hits, lp,
                                                     pr, scc, sssp, tc)
    os.makedirs(out_dir, exist_ok=True)
    src = _sssp_sources(ec)[0]
    runs = (("pr_profile.txt", lambda: pr.vgl_page_rank(
                pr_graph, max_iterations=10, use_convergence=False)),
            ("bfs_do_profile.txt",
             lambda: bfs.vgl_bfs_device(bfs_graph, bfs_root)),
            ("sssp_all_active_profile.txt",
             lambda: sssp.vgl_dijkstra_all_active(bfs_graph, ea, src)),
            ("hits_profile.txt", lambda: hits.vgl_hits(bfs_graph, 20)),
            ("scc_profile.txt", lambda: scc.vgl_forward_backward(pr_graph)),
            ("coloring_profile.txt", lambda: coloring.vgl_coloring(
                pr_graph, core_colors=core)),
            ("lp_profile.txt", lambda: lp.vgl_label_propagation(
                pr_graph, max_iterations=10)),
            ("triangles_profile.txt", lambda: tc.vgl_triangle_count(
                pr_ec, _oriented=oriented, device=DEVICE)))
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


SHARDS = 4                  # phase 16 (a) and (c): one card, shards in turn
RANK_SHARDS = 2             # phase 16 (b): ranks that share the card
HITS_ITERS = 20
PATHS16 = (f"sharded_scan_rmat{BFS_SCALE}", f"sharded_ranks_rmat{BFS_SCALE}",
           f"sharded_loaded_rmat{SCALE}")


def _kernels() -> dict:
    """The port's kernel wrappers by name, each counting its launches."""
    from vectorgraphlibrary_tpu_torch.ops.cuda import and_popcount as ap
    from vectorgraphlibrary_tpu_torch.ops.cuda import lane_shuffle as ls
    from vectorgraphlibrary_tpu_torch.ops.cuda import pull_reduce as pl
    from vectorgraphlibrary_tpu_torch.ops.cuda import pull_rows as prw
    from vectorgraphlibrary_tpu_torch.ops.cuda import push_expand as pe
    from vectorgraphlibrary_tpu_torch.ops.cuda import route_gather as rg
    from vectorgraphlibrary_tpu_torch.ops.cuda import scatter_combine as scm
    return dict(lane_shuffle=ls.lane_shuffle,
                route_gather_finish=rg.route_gather_finish,
                pull_reduce=pl.pull_reduce, push_expand=pe.push_expand,
                scatter_combine=scm.scatter_combine,
                scatter_combine_sorted=scm.scatter_combine_sorted,
                and_popcount=ap.and_popcount, pull_rows=prw.pull_rows,
                segment_reduce=pl.segment_reduce)


def _nbytes(obj) -> int:
    return sum(t.numel() * t.element_size()
               for t in _graph_tensors(obj).values()
               if isinstance(t, torch.Tensor))


def _sharded_rank(rank: int, world: int, device, coo: str, root: int,
                  iterations: int) -> dict:
    """One rank of phase 16 (b), spawned by parallel/launch.run_ranks: its
    own shard (import_shard) of the COO graph in `coo`, then
    make_pr_sharded (`iterations`) and, for root >= 0, make_bfs_sharded
    from root; each call with the launches of every kernel set to 0 just
    before it and read just after, and its time by DeviceTimer (the first
    call of each: it makes the shard's pull plans)."""
    from vectorgraphlibrary_tpu_torch.io.edges_container import (
        EdgesContainer)
    from vectorgraphlibrary_tpu_torch.parallel import sharded
    from vectorgraphlibrary_tpu_torch.parallel.mesh import make_mesh
    from vectorgraphlibrary_tpu_torch.parallel.shard_build import import_shard
    from vectorgraphlibrary_tpu_torch.runtime.timer import DeviceTimer
    kernels = _kernels()
    with np.load(coo) as z:
        ec = EdgesContainer(z["src"], z["dst"], int(z["v"]))
    t0 = time.perf_counter()
    g = import_shard(ec, world, rank, device=device)
    out = dict(import_s=time.perf_counter() - t0, shard_mib=_nbytes(g) / 2**20)
    mesh = make_mesh(world, 1, device)
    runs = [("pr", sharded.make_pr_sharded(g, mesh, ec,
                                           max_iterations=iterations), ())]
    if root >= 0:
        runs.append(("bfs", sharded.make_bfs_sharded(g, mesh), (root,)))
    for name, fn, args in runs:
        for k in kernels.values():
            k.launches = 0
        timer = DeviceTimer(device).start()
        res = fn(*args)
        out[f"{name}_ms"] = timer.stop(res) * 1e3
        out[f"{name}_launches"] = np.asarray([k.launches
                                              for k in kernels.values()])
        out[name] = res.cpu().numpy()
    out["kernel_names"] = np.asarray(list(kernels))
    return out


def phase_sharded(kernels: dict, ec, graph, ea, bfs_root: int, root_levels,
                  fixed: dict, ec18, smi: str, keep_dir: str) -> dict:
    """Distribution on one card. (a) import_sharded of the weighted
    RMAT-20 graph in SHARDS shards and the one-card runners (PageRank,
    BFS, SSSP, CC, HITS), each equal to the unsharded entry points'
    results of phases 6 and 10 (PageRank: this phase's vgl_page_rank on
    the same graph, held to seq_page_rank), with its launches per call,
    times (median of 3 by DeviceTimer), MTEPS and peak memory; (b) the
    rank-parallel runners: RANK_SHARDS gloo ranks on CUDA tensors sharing
    the card, each building its own shard from a COO file, and at the
    same time a one-rank NCCL group with one shard, equal to the same
    results; (c) sharded save and load of the RMAT-18 graph in SHARDS
    shards, PageRank on the loaded graph bit-equal to the fresh one's. The
    reference PageRank, (a)'s import and (c) run on this process while
    (b)'s ranks run; (a)'s calls are counted and timed after they end.
    Returns the launches on each path, the numbers printed and, for phase
    17, (a)'s sharded graph, weights and host CSRs, and (c)'s loaded graph
    and its files' prefix (under keep_dir)."""
    from concurrent.futures import ThreadPoolExecutor
    from vectorgraphlibrary_tpu_torch.graph.persistence import (
        load_sharded_graph, save_sharded_graph)
    from vectorgraphlibrary_tpu_torch.graph.vertices import as_original_numpy
    from vectorgraphlibrary_tpu_torch.models import pr
    from vectorgraphlibrary_tpu_torch.parallel import shard_build, sharded
    from vectorgraphlibrary_tpu_torch.parallel.launch import run_ranks
    from vectorgraphlibrary_tpu_torch.runtime.timer import DeviceTimer
    from vectorgraphlibrary_tpu_torch.utils.verify import (
        verify_ranking_results)
    launches = {p: dict.fromkeys(kernels, 0) for p in PATHS16}
    v, e = graph.v, graph.e
    numbers = {}
    kept = {}

    def close(label, got, want, hits=False):
        atol = 1e-6 * float(np.abs(want).max()) if hits else 0.0
        if got.shape != want.shape or not np.allclose(got, want, rtol=1e-5,
                                                      atol=atol):
            raise AssertionError(f"{label}: differs from the unsharded "
                                 f"result beyond rtol 1e-5")

    def equal(label, got, want):
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"{label}: differs from the unsharded result")

    def reference_pagerank():
        """The unsharded vgl_page_rank on the same graph, held to
        seq_page_rank (no earlier phase runs PageRank on RMAT-20)."""
        t0 = time.perf_counter()
        want_pr = as_original_numpy(pr.vgl_page_rank(
            graph, max_iterations=ITERS, use_convergence=False)[0], graph)
        errors = verify_ranking_results(want_pr, pr.seq_page_rank(
            ec, max_iterations=ITERS, use_convergence=False))
        if errors:
            raise AssertionError(f"unsharded PageRank on RMAT-{BFS_SCALE}: "
                                 f"error count {errors}")
        print(f"  unsharded vgl_page_rank on RMAT-{BFS_SCALE} ({ITERS} "
              f"iterations): error count 0 against seq_page_rank "
              f"({time.perf_counter() - t0:.2f} s with the oracle)")
        return want_pr

    def import_scan():
        """(a) one card, the shards in turn: the import."""
        t0 = time.perf_counter()
        hosts = []
        sg = shard_build.import_sharded(ec, SHARDS, device=DEVICE,
                                        _host_out=hosts)
        weights = shard_build.shard_edge_values(ec.weights, sg, ec, hosts)
        kept.update(hosts=hosts)
        torch.cuda.synchronize()
        numbers["import_sharded_s"] = time.perf_counter() - t0
        numbers["sharded_graph_mib"] = _nbytes(sg.shards) / 2**20
        numbers["graph_mib"] = _nbytes(graph) / 2**20
        numbers["sharded_weights_mib"] = _nbytes(weights) / 2**20
        numbers["weights_mib"] = _nbytes(ea) / 2**20
        print(f"  import_sharded({SHARDS}) + shard_edge_values: "
              f"{numbers['import_sharded_s']:.2f} s; edges per shard "
              f"{list(sg.edges_per_shard)}, v_pad {sg.v_pad}; device bytes: "
              f"shards {numbers['sharded_graph_mib']:.1f} MiB against "
              f"{numbers['graph_mib']:.1f} MiB unsharded, weights "
              f"{numbers['sharded_weights_mib']:.1f} against "
              f"{numbers['weights_mib']:.1f} MiB")
        return sg, weights

    # (c) sharded save and load of RMAT-18
    def save_and_load():
        """(c), run while the ranks of (b) run."""
        ls = kernels["lane_shuffle"]
        sg18 = shard_build.import_sharded(ec18, SHARDS, device=DEVICE)
        fresh = sharded.pagerank_sharded_scan(sg18, ec18, ITERS)
        prefix = os.path.join(keep_dir, f"rmat{SCALE}")
        t0 = time.perf_counter()
        save_sharded_graph(sg18, prefix)
        numbers["save_s"] = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(keep_dir, f))
                   for f in os.listdir(keep_dir) if f.startswith(
                       f"rmat{SCALE}."))
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        loaded = load_sharded_graph(prefix, device=DEVICE)
        torch.cuda.synchronize()
        numbers["load_s"] = time.perf_counter() - t0
        n_ls = ls.launches
        ranks = sharded.pagerank_sharded_scan(loaded, ec18, ITERS)
        torch.cuda.synchronize()
        kept.update(loaded18=loaded, prefix18=prefix)
        n = {name: k.launches for name, k in kernels.items()}
        launches[PATHS16[2]] = n
        print(f"  save_sharded_graph RMAT-{SCALE} in {SHARDS} shards: "
              f"{numbers['save_s']:.2f} s, {size / 2**20:.1f} MiB; "
              f"load_sharded_graph on {DEVICE}: {numbers['load_s']:.2f} s, "
              f"lane_shuffle {n_ls} launches; launches of load + PageRank {n}")
        if n_ls != 8 * SHARDS:
            raise AssertionError(f"load launched lane_shuffle {n_ls} times, "
                                 f"expected {8 * SHARDS} (two per plan)")
        want = dict.fromkeys(kernels, 0)
        want.update(lane_shuffle=8 * SHARDS, pull_reduce=SHARDS * ITERS,
                    route_gather_finish=2 * SHARDS * ITERS)
        if n != want:
            raise AssertionError(f"load + PageRank: launches {n}, "
                                 f"expected {want}")
        for s in range(SHARDS):
            _assert_same_graph(f"loaded shard {s}", loaded.shard(s),
                               sg18.shard(s))
        if not torch.equal(ranks, fresh):
            raise AssertionError("PageRank on the loaded sharded graph "
                                 "differs")
        print("  pagerank_sharded_scan on the loaded graph: bit-identical to "
              "the fresh sharded graph's")
        numbers["lane_shuffle_launches"] = n_ls

    # (b) one shard per rank, the ranks sharing the card
    with tempfile.TemporaryDirectory() as d:
        coo = os.path.join(d, "coo.npz")
        np.savez(coo, src=ec.src_ids, dst=ec.dst_ids, v=np.int64(v))
        t0 = time.perf_counter()
        fn = "chip_smoke:_sharded_rank"
        with ThreadPoolExecutor(2) as pool:
            gloo = pool.submit(run_ranks, fn, RANK_SHARDS, device=DEVICE,
                               backend="gloo", timeout=600, kwargs=dict(
                                   coo=coo, root=bfs_root, iterations=ITERS))
            nccl = pool.submit(run_ranks, fn, 1, device=DEVICE, timeout=600,
                               kwargs=dict(coo=coo, root=-1,
                                           iterations=ITERS))
            # the parent's host work runs while the ranks run; the scans
            # are timed after they end
            want_pr = reference_pagerank()
            sg, weights = import_scan()
            save_and_load()
            gloo, nccl = gloo.result(), nccl.result()
    numbers["ranks_wall_s"] = time.perf_counter() - t0
    # (a) timed, the ranks done
    res = fixed

    def bfs_check(out):
        equal("bfs_sharded_scan", out[:v].cpu().numpy(), root_levels)
        return int(out.max())

    def sssp_check(out):
        equal("sssp_sharded_scan", out[0][:v].cpu().numpy(), res["sssp"])
        return out[1]

    def cc_check(out):
        equal("cc_sharded_scan", out[0][:v].cpu().numpy(), res["cc"])
        return out[1]

    def pr_check(out):
        close("pagerank_sharded_scan", out[:v].cpu().numpy(), want_pr)
        return ITERS

    def hits_check(out):
        close("hits_sharded_scan auth", out[0].cpu().numpy(),
              res["hits_auth"], hits=True)
        close("hits_sharded_scan hub", out[1].cpu().numpy(), res["hits_hub"],
              hits=True)
        return HITS_ITERS

    S = SHARDS
    cases = [  # label, call, check -> loop count, (pulls, routes) per loop,
               # edges per call for MTEPS (bench.py's formulas)
        ("pagerank", lambda: sharded.pagerank_sharded_scan(sg, ec, ITERS),
         pr_check, (S, 2 * S), e * ITERS),
        ("bfs", lambda: sharded.bfs_sharded_scan(sg, bfs_root), bfs_check,
         (S, 2 * S), e),
        ("sssp", lambda: sharded.sssp_sharded_scan(
            sg, weights, res["sssp_source"]), sssp_check, (S, 3 * S), e),
        ("cc", lambda: sharded.cc_sharded_scan(sg), cc_check,
         (2 * S, 4 * S), e),
        ("hits", lambda: sharded.hits_sharded_scan(sg, HITS_ITERS),
         hits_check, (2 * S, 4 * S), e * HITS_ITERS)]
    for label, call, check, (pulls, routes), work in cases:
        for k in kernels.values():
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        out = call()
        torch.cuda.synchronize()
        n = {name: k.launches for name, k in kernels.items()}
        peak = torch.cuda.max_memory_allocated() / 2**20
        loops = check(out)
        want = dict.fromkeys(kernels, 0)
        want.update(pull_reduce=pulls * loops, route_gather_finish=routes
                    * loops)
        if n != want:
            raise AssertionError(f"{label}_sharded_scan: launches {n}, "
                                 f"expected {want}")
        for name in n:
            launches[PATHS16[0]][name] += n[name]
        ts = []
        for _ in range(3):
            timer = DeviceTimer(DEVICE).start()
            ts.append(timer.stop(call()))
        ms = statistics.median(ts) * 1e3
        numbers[label] = dict(ms=ms, mteps=work / (ms / 1e3) / 1e6,
                              loops=loops, pull_reduce=n["pull_reduce"],
                              route_gather_finish=n["route_gather_finish"],
                              peak_mib=peak)
        print(f"  {label}_sharded_scan: equal to the unsharded result; "
              f"{loops} loops, launches per call pull_reduce "
              f"{n['pull_reduce']}, route_gather_finish "
              f"{n['route_gather_finish']}; {ms:.3f} ms (median of "
              f"{', '.join(f'{t * 1e3:.3f}' for t in ts)}), "
              f"{numbers[label]['mteps']:.1f} MTEPS, peak {peak:.1f} MiB "
              f"on {smi}")
    kept.update(sg=sg, weights=weights)

    names = [str(x) for x in gloo[0]["kernel_names"]]
    max_level = int(root_levels.max())
    for label, ranks, world in (("gloo", gloo, RANK_SHARDS),
                                ("nccl", nccl, 1)):
        for r, out in enumerate(ranks):
            close(f"make_pr_sharded, {label} rank {r}", out["pr"][:v],
                  want_pr)
            runs = [("pr", ITERS)]
            if "bfs" in out:
                equal(f"make_bfs_sharded, {label} rank {r}", out["bfs"][:v],
                      root_levels)
                runs.append(("bfs", max_level))
            for run, loops in runs:
                n = dict(zip(names, out[f"{run}_launches"].tolist()))
                want = dict.fromkeys(names, 0)
                want.update(pull_reduce=loops, route_gather_finish=2 * loops)
                if n != want:
                    raise AssertionError(f"{label} rank {r} {run}: launches "
                                         f"{n}, expected {want}")
                for name in n:
                    launches[PATHS16[1]][name] += n[name]
            numbers[f"{label}_rank{r}"] = {
                k: float(out[k]) for k in ("import_s", "shard_mib", "pr_ms",
                                           "bfs_ms") if k in out}
            print(f"  {label} rank {r} of {world}: equal to the unsharded "
                  f"results; import_shard {float(out['import_s']):.2f} s, "
                  f"shard {float(out['shard_mib']):.1f} MiB, first "
                  f"make_pr_sharded call {float(out['pr_ms']):.1f} ms"
                  + (f", first make_bfs_sharded call "
                     f"{float(out['bfs_ms']):.1f} ms" if "bfs" in out else "")
                  + f" (correctness run: ranks share the card) on {smi}")
    print(f"  the ranks (both groups at once: each process started, imported "
          f"and built its shard) beside this process's reference PageRank, "
          f"import and save and load: {numbers['ranks_wall_s']:.2f} s")

    return dict(launches=launches, numbers=numbers, kept=kept)


PATHS17 = (f"part2_scan_rmat{BFS_SCALE}", f"part2_ranks_rmat{BFS_SCALE}",
           f"streamed_rmat{SCALE}", f"jax_slim_load_rmat{SCALE}")
GLOO_SCALE = 16            # phase 17 (b): the gloo ranks' graph
STREAM_ITERS = 20          # phase 17 (c): PageRank iterations (HITS: half)
SAGE_PARAMS = ("w_self1", "w_nbr1", "b1", "w_self2", "w_nbr2", "b2")


def _sage_setup(v_pad: int, v: int, device) -> tuple:
    """GraphSAGE's parameters at (SAGE_IN, SAGE_HIDDEN, SAGE_CLASSES) and
    its inputs in ORIGINAL order (features, labels, a mask of half the real
    vertices; zeros on the padding), from a generator seeded with SEED on
    `device`: the same numbers in every process on the card."""
    from vectorgraphlibrary_tpu_torch.models import gnn
    gen = torch.Generator(device).manual_seed(SEED)
    params = gnn.init_sage(gen, SAGE_IN, SAGE_HIDDEN, SAGE_CLASSES)
    pad = v_pad - v         # drawn for the v real vertices: any v_pad
    feats = torch.nn.functional.pad(torch.randn(
        (v, SAGE_IN), generator=gen, device=device), (0, 0, 0, pad))
    labels = torch.nn.functional.pad(torch.randint(
        0, SAGE_CLASSES, (v,), generator=gen, device=device,
        dtype=torch.int32), (0, pad))
    mask = torch.nn.functional.pad(
        torch.rand(v, generator=gen, device=device) < 0.5, (0, pad))
    return params, feats, labels, mask


def _sage_unsharded(graph) -> tuple:
    """The unsharded models/gnn loss and gradients on _sage_setup's
    inputs, brought into the graph's GATHER ordering."""
    from vectorgraphlibrary_tpu_torch.models import gnn
    params, feats, labels, mask = _sage_setup(graph.v_pad, graph.v,
                                              graph.device)
    idx = graph.vertex_route_g_from_o.fwd_idx.long()
    loss = gnn.sage_loss(params, graph, feats[idx], labels[idx], mask[idx])
    loss.backward()
    return float(loss.detach()), {k: getattr(params, k).grad.cpu().numpy()
                                  for k in SAGE_PARAMS}


def _part2_rank(rank: int, world: int, device, coo: str, source: int,
                root: int, hub: int, roots: list, sage: bool) -> dict:
    """One rank of phase 17 (b), spawned by parallel/launch.run_ranks: its
    own shard of the weighted COO graph in `coo`, then the rank drivers of
    distribution part 2 (coloring, partial SSSP from `source`, DO-BFS from
    `root`, MS-BFS from `roots`, CC hybrid from `hub`), each with the
    launches of every kernel set to 0 just before it and read just after,
    and its time by DeviceTimer (the first call). With `sage`, the sharded
    GraphSAGE loss and gradients on _sage_setup's inputs, then 3 Adam steps
    (SAGE_LR), each counted and timed."""
    from vectorgraphlibrary_tpu_torch.io.edges_container import (
        EdgesContainer)
    from vectorgraphlibrary_tpu_torch.parallel import sharded
    from vectorgraphlibrary_tpu_torch.parallel.mesh import make_mesh
    from vectorgraphlibrary_tpu_torch.parallel.shard_build import (
        edge_values_of_shard, import_shard)
    from vectorgraphlibrary_tpu_torch.runtime.timer import DeviceTimer
    kernels = _kernels()
    with np.load(coo) as z:
        ec = EdgesContainer(z["src"], z["dst"], int(z["v"]), z["w"])
    t0 = time.perf_counter()
    hosts = []
    g = import_shard(ec, world, rank, device=device, _host_out=hosts)
    w = edge_values_of_shard(ec.weights, ec, world, rank, g, hosts[0])
    out = dict(import_s=time.perf_counter() - t0)
    mesh = make_mesh(world, 1, device)

    def counted(name, fn):
        for k in kernels.values():
            k.launches = 0
        timer = DeviceTimer(device).start()
        res = fn()
        out[f"{name}_ms"] = timer.stop(res) * 1e3
        out[f"{name}_launches"] = np.asarray([k.launches
                                              for k in kernels.values()])
        return res
    # each driver made first (make_bfs_do_sharded routes and all-reduces
    # the out-degrees there), then its call counted
    run = sharded.make_coloring_sharded(g, mesh)
    out["coloring"] = counted("coloring", run).cpu().numpy()
    run = sharded.make_sssp_sharded_partial(g, mesh, w)
    out["sssp_partial"] = counted("sssp_partial",
                                  lambda: run(source)).cpu().numpy()
    run = sharded.make_bfs_do_sharded(g, mesh)
    out["bfs_do"] = counted("bfs_do", lambda: run(root)).cpu().numpy()
    run = sharded.make_msbfs_sharded(g, mesh)
    out["msbfs"] = counted("msbfs", lambda: run(roots)).cpu().numpy()
    run = sharded.make_cc_hybrid_sharded(g, mesh)
    labels, flood, hooks = counted("cc_hybrid", lambda: run(hub))
    out.update(cc_hybrid=labels.cpu().numpy(),
               cc_hybrid_counts=np.asarray([flood, hooks]))
    if sage:
        params, feats, cls, mask = _sage_setup(g.v_pad, g.v, device)
        loss_fn = sharded.make_sage_loss_sharded(g, mesh)
        loss = counted("sage_grad", lambda: loss_fn(params, feats, cls, mask))
        loss.backward()
        out["sage_loss"] = float(loss.detach())
        out.update({f"grad_{k}": getattr(params, k).grad.cpu().numpy()
                    for k in SAGE_PARAMS})
        step = sharded.make_sage_train_step_sharded(
            g, mesh, torch.optim.Adam(params.parameters(), lr=SAGE_LR))
        losses = []
        for i in range(3):
            losses.append(float(counted(f"sage_step{i}", lambda: step(
                params, feats, cls, mask))))
        out["sage_losses"] = np.asarray(losses)
    out["kernel_names"] = np.asarray(list(kernels))
    return out


def _do_bfs_top_down(levels: np.ndarray, ec, alpha: float = 15.0,
                     beta: float = 18.0, id_cap: int = 1 << 12,
                     edge_cap: int = 1 << 16) -> int:
    """The levels that make_bfs_do_sharded (at its defaults) sends
    top-down, replayed on the host: its Beamer test, level by level, on
    the global out-degrees and edge count of ec, with each level's
    frontier read from `levels` ([v_pad] ORIGINAL, source 1, -1 unvisited;
    held elsewhere to the unsharded BFS's)."""
    f32 = np.float32
    v = ec.vertices_count
    id_cap = min(id_cap, len(levels))
    lv = np.asarray(levels[:v])
    outdeg = np.bincount(ec.src_ids, minlength=v).astype(np.int64)
    size, nbrs = 1, int(outdeg[lv == 1].sum())
    cur, unexplored, td = 1, min(len(ec.src_ids), 2**31 - 1), 0
    while size > 0:
        td += bool(((f32(nbrs) < f32(unexplored) / f32(alpha))
                    or (f32(size) * f32(beta) < f32(v)))
                   and size < id_cap and nbrs < edge_cap)
        newly = lv == cur + 1
        size, nbrs = int(newly.sum()), int(outdeg[newly].sum())
        cur, unexplored = cur + 1, max(unexplored - nbrs, 0)
    return td


def _coloring_valid(ec, colors: np.ndarray) -> bool:
    nonloop = ec.src_ids != ec.dst_ids
    return bool((colors >= 0).all() and (colors[ec.src_ids[nonloop]]
                                         != colors[ec.dst_ids[nonloop]]).all())


def _msbfs_edges(ec, levels: np.ndarray) -> int:
    """Edges the roots of an MS-BFS traversed: the out-degrees of the
    vertices each reached."""
    outdeg = np.bincount(ec.src_ids, minlength=ec.vertices_count)
    return int(((levels[:, :ec.vertices_count] > 0) * outdeg).sum())


def phase_part2(kernels: dict, ec, graph, bfs_root: int, root_levels,
                fixed: dict, ec18, p16: dict, smi: str) -> dict:
    """Distribution part 2 on one card. (a) On phase 16's weighted RMAT-20
    shards: msbfs_sharded_scan from 32 roots equal to vgl_msbfs,
    cc_hybrid_sharded_scan from the largest out-degree vertex in phase
    10's partition; the same shards slim (slim_value_pull): their device
    bytes against the full shards', PageRank, BFS and CC on them bit-equal
    to the full shards'; sssp_sharded_scan_hash partial and all-active on
    them, equal to each other and to a host Dijkstra on the hashed
    weights; each with its launches against the counts the code predicts,
    its time (median of 3 by DeviceTimer) and MTEPS. (b) The five rank
    drivers on 2 gloo ranks sharing the card (RMAT-GLOO_SCALE) and on a
    one-rank NCCL group (RMAT-20), equal to the one-card results, the
    coloring valid; the sharded GraphSAGE at ogbn-products' widths: on
    the NCCL rank its loss and gradients equal the unsharded step's, with
    3 pull_rows launches and the ms of each Adam step; on the gloo ranks
    its gradients equal the unsharded ones. (c) Streaming phase 16's saved
    RMAT-18 shards and their hashed weights (save_sharded_weights) from
    pinned host memory: the five streamed algorithms equal the resident
    scans; host-to-device GB/s, each sweep's ms and the peak device memory
    against two shards and the state. (d) Those files as the JAX package's
    slim shards, loaded on the card with their CSRs rebuilt: equal to the
    full load, the scans bit-equal. Returns the launches on each path and
    the numbers printed."""
    from concurrent.futures import ThreadPoolExecutor
    from vectorgraphlibrary_tpu_torch.config import TraversalDirection
    from vectorgraphlibrary_tpu_torch.graph.device import import_graph
    from vectorgraphlibrary_tpu_torch.graph.persistence import (
        load_sharded_graph, load_sharded_weights, save_jax_slim_sharded,
        save_sharded_weights)
    from vectorgraphlibrary_tpu_torch.io import generation
    from vectorgraphlibrary_tpu_torch.models import bfs, cc, common, sssp
    from vectorgraphlibrary_tpu_torch.parallel import shard_build, sharded
    from vectorgraphlibrary_tpu_torch.parallel import streaming
    from vectorgraphlibrary_tpu_torch.parallel.launch import run_ranks
    from vectorgraphlibrary_tpu_torch.runtime.timer import DeviceTimer
    from vectorgraphlibrary_tpu_torch.utils.verify import (
        equal_components, verify_results)
    launches = {p: dict.fromkeys(kernels, 0) for p in PATHS17}
    numbers = {}
    kept = p16["kept"]
    sg, hosts = kept["sg"], kept["hosts"]
    v, e, S = graph.v, graph.e, SHARDS
    res = fixed
    outdeg = np.bincount(ec.src_ids, minlength=v)
    hub = int(np.argmax(outdeg))
    rng = np.random.default_rng(SEED)
    roots = [int(r) for r in rng.choice(np.flatnonzero(outdeg), 32,
                                        replace=False)]

    def equal(label, got, want):
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"{label}: differs from the one-card result")

    def count_check(label, n, want_counts):
        want = dict.fromkeys(kernels, 0)
        want.update(want_counts)
        if n != want:
            raise AssertionError(f"{label}: launches {n}, expected {want}")

    def coloring_rounds(g):
        """coloring_sharded_scan's colors and its round count: each round
        pulls (2 + 4 words) values over both directions of every shard."""
        kernels["pull_reduce"].launches = 0
        colors = sharded.coloring_sharded_scan(g).cpu().numpy()
        return colors, kernels["pull_reduce"].launches // (12 * g.n_shards)

    # (b) starts first: the ranks build their shards while this process
    # works; (a)'s and (c)'s calls are timed after they end
    ec16 = generation.rmat(GLOO_SCALE, BFS_DEGREE, seed=SEED, weighted=True)
    out16 = np.bincount(ec16.src_ids, minlength=ec16.vertices_count)
    gloo_kw = dict(source=common.select_random_source(ec16, seed=1),
                   root=common.select_random_source(ec16, seed=2),
                   hub=int(np.argmax(out16)),
                   roots=[common.select_random_source(ec16, seed=s)
                          for s in range(32)], sage=True)
    nccl_kw = dict(source=int(res["sssp_source"]), root=int(bfs_root),
                   hub=hub, roots=roots, sage=True)
    with tempfile.TemporaryDirectory() as d:
        coo20, coo16 = os.path.join(d, "coo20.npz"), os.path.join(d,
                                                                  "coo16.npz")
        for path, c in ((coo20, ec), (coo16, ec16)):
            np.savez(path, src=c.src_ids, dst=c.dst_ids,
                     v=np.int64(c.vertices_count), w=c.weights)
        t0 = time.perf_counter()
        fn = "chip_smoke:_part2_rank"
        with ThreadPoolExecutor(2) as pool:
            gloo = pool.submit(run_ranks, fn, RANK_SHARDS, device=DEVICE,
                               backend="gloo", timeout=600,
                               kwargs=dict(coo=coo16, **gloo_kw))
            nccl = pool.submit(run_ranks, fn, 1, device=DEVICE, timeout=600,
                               kwargs=dict(coo=coo20, **nccl_kw))
            # the one-card references while the ranks run
            hs16 = []
            sg16 = shard_build.import_sharded(ec16, RANK_SHARDS,
                                              device=DEVICE, _host_out=hs16)
            w16 = shard_build.shard_edge_values(ec16.weights, sg16, ec16,
                                                hs16)
            lab16, fl16, hk16 = sharded.cc_hybrid_sharded_scan(
                sg16, gloo_kw["hub"])
            color16, rounds16 = coloring_rounds(sg16)
            dist16, sweeps16 = sharded.sssp_sharded_scan(
                sg16, w16, gloo_kw["source"])
            want16 = dict(
                coloring=color16, sssp_partial=dist16.cpu().numpy(),
                bfs_do=sharded.bfs_sharded_scan(
                    sg16, gloo_kw["root"]).cpu().numpy(),
                msbfs=sharded.msbfs_sharded_scan(
                    sg16, gloo_kw["roots"]).cpu().numpy(),
                cc_hybrid=lab16.cpu().numpy(),
                cc_hybrid_counts=np.asarray([fl16, hk16]))
            sage16 = _sage_unsharded(import_graph(ec16, device=DEVICE))
            del sg16, w16
            want_color20, rounds20 = coloring_rounds(sg)
            sweeps20 = sharded.sssp_sharded_scan(sg, kept["weights"],
                                                 int(res["sssp_source"]))[1]
            sage20 = _sage_unsharded(graph)
            slim = shard_build.ShardedTileGraph(
                shards=tuple(shard_build.slim_value_pull(g)
                             for g in sg.shards),
                edges_per_shard=sg.edges_per_shard, n_shards=S, v=sg.v,
                v_pad=sg.v_pad, e=sg.e)
            # the hashed weights of every COO edge, for the host Dijkstra
            w_coo = np.zeros(ec.edges_count, np.float32)
            fn_w = sharded.slot_hash_weight_fn(
                sharded.route_slot_count(slim.shard(0)))
            shard_id = ec.dst_ids % S
            for s, g in enumerate(slim.shards):
                h_in = hosts[s][1]
                n_e = h_in.edges_count
                part = np.zeros(n_e, np.float32)
                part[h_in.edge_perm[:n_e]] = \
                    fn_w(s, g).flat[:n_e].cpu().numpy()
                w_coo[shard_id == s] = part
            t1 = time.perf_counter()
            ssrc = int(res["sssp_source"])
            want_hash = sssp.seq_dijkstra(dataclasses.replace(
                ec, weights=w_coo), ssrc)
            print(f"  host Dijkstra on the hashed weights: "
                  f"{time.perf_counter() - t1:.2f} s")
            # (c)'s host side: the hashed weights of the RMAT-18 shards
            # saved, then the files loaded into pinned host memory
            loaded18, prefix18 = kept["loaded18"], kept["prefix18"]
            fn18 = sharded.slot_hash_weight_fn(
                sharded.route_slot_count(loaded18.shard(0)))
            from vectorgraphlibrary_tpu_torch.graph.edges import EdgeArray
            hashed18 = [EdgeArray(outgoing=None, incoming=fn18(s, g))
                        for s, g in enumerate(loaded18.shards)]
            save_sharded_weights(sharded.route_slot_weights(loaded18,
                                                            hashed18),
                                 prefix18)
            t1 = time.perf_counter()
            ssg = streaming.load_streamed(prefix18, weights=True,
                                          device=DEVICE)
            numbers["load_streamed_s"] = time.perf_counter() - t1
            # (d)'s files: the same shards as the JAX package's slim shards
            # (the advance route kept; the CSRs, renumber maps and tiles'
            # adjacency dropped: this host has no JAX to write them),
            # loaded on the card with each CSR rebuilt from the route
            jprefix = f"{prefix18}_jax_slim"
            t1 = time.perf_counter()
            save_jax_slim_sharded(prefix18, jprefix)
            numbers["jax_slim_write_s"] = time.perf_counter() - t1
            for k in kernels.values():
                k.launches = 0
            t1 = time.perf_counter()
            jslim18 = load_sharded_graph(jprefix, device=DEVICE)
            torch.cuda.synchronize()
            numbers["load_jax_slim_s"] = time.perf_counter() - t1
            n = {name: k.launches for name, k in kernels.items()}
            # two lane_shuffle launches per plan: the advance route and
            # the three vertex routes of each shard, as a full file's load
            count_check("load_sharded_graph of the JAX slim shards", n,
                        dict(lane_shuffle=8 * S))
            for name in n:
                launches[PATHS17[3]][name] += n[name]
            # a slim import uploads only what a slim shard keeps: its peak
            # device memory against the slim shards' bytes (a full shard
            # built and then stripped would add the largest full shard)
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            slim18 = shard_build.import_sharded(ec18, S, device=DEVICE,
                                                slim=True)
            torch.cuda.synchronize()
            numbers["import_slim18_s"] = time.perf_counter() - t1
            peak18 = torch.cuda.max_memory_allocated() - before
            slim18_b = _nbytes(slim18.shards)
            stripped_b = _nbytes([shard_build.slim_value_pull(g)
                                  for g in loaded18.shards])
            numbers.update(import_slim18_peak_mib=peak18 / 2**20,
                           slim18_mib=slim18_b / 2**20)
            if slim18_b != stripped_b or peak18 > 2 * slim18_b:
                raise AssertionError(
                    f"import_sharded(slim=True) of RMAT-{SCALE}: "
                    f"{slim18_b} B against slim_value_pull's {stripped_b}, "
                    f"peak {peak18} B")
            print(f"  import_sharded(RMAT-{SCALE}, {S}, slim=True): "
                  f"{numbers['import_slim18_s']:.2f} s, "
                  f"{slim18_b / 2**20:.1f} MiB (as slim_value_pull of the "
                  f"loaded full shards), peak {peak18 / 2**20:.1f} MiB "
                  f"above the start on {smi}")
            del slim18
            gloo, nccl = gloo.result(), nccl.result()
    numbers["ranks_wall_s"] = time.perf_counter() - t0
    print(f"  the ranks (2 gloo on RMAT-{GLOO_SCALE}, 1 NCCL on "
          f"RMAT-{BFS_SCALE}) beside this process's references and loads: "
          f"{numbers['ranks_wall_s']:.2f} s; load_streamed RMAT-{SCALE} "
          f"{numbers['load_streamed_s']:.2f} s")

    # (a) one card, the shards in turn, counted and timed
    full_bytes, slim_bytes = _nbytes(sg.shards), _nbytes(slim.shards)
    numbers.update(full_shards_mib=full_bytes / 2**20,
                   slim_shards_mib=slim_bytes / 2**20)
    print(f"  slim shards of RMAT-{BFS_SCALE} in {S}: "
          f"{slim_bytes / 2**20:.1f} MiB on the card against the full "
          f"shards' {full_bytes / 2**20:.1f} MiB ({slim_bytes / full_bytes:.3f}"
          f" of it) on {smi}")
    g_ms = bfs.vgl_msbfs(graph, roots).values
    want_ms = torch.stack([common.to_direction(
        graph, g_ms[i], TraversalDirection.SCATTER,
        TraversalDirection.ORIGINAL) for i in range(32)])[:, :v].cpu().numpy()
    full_pr = sharded.pagerank_sharded_scan(sg, ec, ITERS)
    full_bfs = sharded.bfs_sharded_scan(sg, bfs_root)
    full_cc = sharded.cc_sharded_scan(sg)

    def msbfs_check(out):
        equal("msbfs_sharded_scan", out[:, :v].cpu().numpy().astype(
            np.int32), want_ms)
        return int(out.max())

    def hybrid_check(out):
        labels, fl, hk = out
        if equal_components(labels[:v].cpu().numpy(), res["cc"]):
            raise AssertionError("cc_hybrid_sharded_scan: another partition "
                                 "than phase 10's CC")
        return fl + hk

    def same(label, want):
        def check(out):
            got = out[0] if isinstance(out, tuple) else out
            if not torch.equal(got, want[0] if isinstance(want, tuple)
                               else want):
                raise AssertionError(f"{label} on slim shards differs from "
                                     f"the full shards'")
            if label == "pagerank":
                return ITERS
            if label == "bfs":
                return int(got.max())
            return out[1]
        return check

    hash_out = {}

    def hash_check(partial):
        def check(out):
            dist, it = out
            hash_out[partial] = dist
            errors = verify_results(dist[:v].cpu().numpy(), want_hash)
            if errors:
                raise AssertionError(f"sssp_sharded_scan_hash (partial="
                                     f"{partial}): error count {errors} "
                                     f"against the host Dijkstra")
            return it
        return check

    ms_edges = _msbfs_edges(ec, want_ms)
    cases = [  # label, call, check -> loops, (pulls, routes) per loop, work
        ("msbfs", lambda: sharded.msbfs_sharded_scan(sg, roots), msbfs_check,
         (S, 2 * S), ms_edges),
        ("cc_hybrid", lambda: sharded.cc_hybrid_sharded_scan(sg, hub),
         hybrid_check, (2 * S, 4 * S), e),
        ("slim_pagerank", lambda: sharded.pagerank_sharded_scan(slim, ec,
                                                                ITERS),
         same("pagerank", full_pr), (S, 2 * S), e * ITERS),
        ("slim_bfs", lambda: sharded.bfs_sharded_scan(slim, bfs_root),
         same("bfs", full_bfs), (S, 2 * S), e),
        ("slim_cc", lambda: sharded.cc_sharded_scan(slim),
         same("cc", full_cc), (2 * S, 4 * S), e),
        ("sssp_hash_partial", lambda: sharded.sssp_sharded_scan_hash(
            slim, ssrc, True), hash_check(True), (S, 3 * S), e),
        ("sssp_hash_all", lambda: sharded.sssp_sharded_scan_hash(
            slim, ssrc, False), hash_check(False), (S, 2 * S), e)]
    for label, call, check, (pulls, routes), work in cases:
        for k in kernels.values():
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        out = call()
        torch.cuda.synchronize()
        n = {name: k.launches for name, k in kernels.items()}
        peak = torch.cuda.max_memory_allocated() / 2**20
        loops = check(out)
        count_check(label, n, dict(pull_reduce=pulls * loops,
                                   route_gather_finish=routes * loops))
        for name in n:
            launches[PATHS17[0]][name] += n[name]
        ts = []
        for _ in range(3):
            timer = DeviceTimer(DEVICE).start()
            ts.append(timer.stop(call()))
        ms = statistics.median(ts) * 1e3
        numbers[label] = dict(ms=ms, mteps=work / (ms / 1e3) / 1e6,
                              loops=loops, pull_reduce=n["pull_reduce"],
                              route_gather_finish=n["route_gather_finish"],
                              peak_mib=peak)
        print(f"  {label}: checked; {loops} loops, launches pull_reduce "
              f"{n['pull_reduce']} (predicted {pulls} x {loops}), "
              f"route_gather_finish {n['route_gather_finish']} (predicted "
              f"{routes} x {loops}); {ms:.3f} ms (median of "
              f"{', '.join(f'{t * 1e3:.3f}' for t in ts)}), "
              f"{numbers[label]['mteps']:.1f} MTEPS, peak {peak:.1f} MiB "
              f"on {smi}")
    if not torch.equal(hash_out[True], hash_out[False]):
        raise AssertionError("sssp_sharded_scan_hash: partial != all-active")
    print("  sssp_sharded_scan_hash: partial and all-active bit-equal")
    del slim

    # (b) the ranks
    names = [str(x) for x in nccl[0]["kernel_names"]]

    def rank_counts(label, out, rounds, sweeps, graph_ec):
        """Each driver's launches on one rank (one shard) against the
        code's counts: coloring 12 pulls and 24 routes a round; partial
        SSSP 1 pull and 3 routes a sweep; MS-BFS 1 pull and 2 routes a
        level, CC hybrid 2 and 4 a flood level or hook; DO-BFS 2 routes a
        level and, per level, 1 pull (bottom-up) or 2 scatter_combine
        (top-down: the owner mark and the min); the GraphSAGE forward 2
        pull_rows, each Adam step 3. DO-BFS's top-down levels are
        replayed on the host (_do_bfs_top_down)."""
        levels = int(out["bfs_do"].max())
        td = _do_bfs_top_down(out["bfs_do"], graph_ec)
        m_ms = int(out["msbfs"].max())
        f_h = int(out["cc_hybrid_counts"].sum())
        want = dict(
            coloring=dict(pull_reduce=12 * rounds,
                          route_gather_finish=24 * rounds),
            sssp_partial=dict(pull_reduce=sweeps,
                              route_gather_finish=3 * sweeps),
            bfs_do=dict(pull_reduce=levels - td, scatter_combine=2 * td,
                        route_gather_finish=2 * levels),
            msbfs=dict(pull_reduce=m_ms, route_gather_finish=2 * m_ms),
            cc_hybrid=dict(pull_reduce=2 * f_h, route_gather_finish=4 * f_h),
            sage_grad=dict(pull_rows=2),
            **{f"sage_step{i}": dict(pull_rows=3) for i in range(3)})
        for run, counts in want.items():
            n = dict(zip(names, out[f"{run}_launches"].tolist()))
            count_check(f"{label} {run}", n, counts)
            for name in n:
                launches[PATHS17[1]][name] += n[name]
        return td, levels

    def grads_close(label, out, want):
        loss, grads = want
        if not np.isclose(float(out["sage_loss"]), loss, rtol=1e-4, atol=0):
            raise AssertionError(f"{label}: sharded loss {out['sage_loss']} "
                                 f"against the unsharded {loss}")
        for k in SAGE_PARAMS:
            g, w = out[f"grad_{k}"], grads[k]
            if not np.allclose(g, w, rtol=1e-4,
                               atol=1e-6 * float(np.abs(w).max())):
                raise AssertionError(f"{label}: gradient of {k} differs from "
                                     f"the unsharded step's")

    for label, ranks, want, want_sage, graph_ec, rounds, sweeps in (
            ("gloo", gloo, want16, sage16, ec16, rounds16, sweeps16),
            ("nccl", nccl, dict(
                coloring=want_color20,
                sssp_partial=np.concatenate([res["sssp"], np.full(
                    sg.v_pad - v, np.inf, np.float32)]),
                bfs_do=np.concatenate([root_levels, np.full(
                    sg.v_pad - v, -1, np.int32)]),
                msbfs=None, cc_hybrid=None), sage20, ec, rounds20,
             sweeps20)):
        for r, out in enumerate(ranks):
            for key, w in want.items():
                if w is not None:
                    equal(f"{label} rank {r} {key}", out[key], w)
            if label == "nccl":
                equal(f"nccl msbfs", out["msbfs"][:, :v].astype(np.int32),
                      want_ms)
                if equal_components(out["cc_hybrid"][:v], res["cc"]):
                    raise AssertionError("nccl cc_hybrid: another partition")
            if not _coloring_valid(graph_ec, out["coloring"][
                    :graph_ec.vertices_count]):
                raise AssertionError(f"{label} rank {r}: invalid coloring")
            grads_close(f"{label} rank {r} GraphSAGE", out, want_sage)
            td, levels = rank_counts(f"{label} rank {r}", out, rounds, sweeps,
                                     graph_ec)
            if not out["sage_losses"][-1] < out["sage_losses"][0]:
                raise AssertionError(f"{label} rank {r}: the loss did not "
                                     f"fall: {out['sage_losses']}")
            msg = ", ".join(f"{run} {float(out[run + '_ms']):.1f} ms" for run
                            in ("coloring", "sssp_partial", "bfs_do",
                                "msbfs", "cc_hybrid"))
            step_ms = [float(out[f"sage_step{i}_ms"]) for i in range(3)]
            numbers[f"{label}_rank{r}"] = dict(
                import_s=float(out["import_s"]), step_ms=step_ms,
                **{run: float(out[run + "_ms"]) for run in (
                    "coloring", "sssp_partial", "bfs_do", "msbfs",
                    "cc_hybrid", "sage_grad")})
            print(f"  {label} rank {r} of {len(ranks)}: equal to the one-card "
                  f"results, coloring valid ({rounds} rounds), GraphSAGE "
                  f"loss and gradients equal the unsharded step's; launches "
                  f"as predicted (DO-BFS {td} top-down of {levels} levels); "
                  f"import_shard "
                  f"{float(out['import_s']):.2f} s; first calls: {msg}; "
                  f"Adam steps {', '.join(f'{t:.2f}' for t in step_ms)} ms "
                  f"(3 pull_rows launches each), loss "
                  f"{out['sage_losses'][0]:.4f} -> "
                  f"{out['sage_losses'][-1]:.4f} (correctness run: ranks "
                  f"share the card) on {smi}")

    # (c) streaming, timed with the card to itself
    sg18 = kept["loaded18"]
    hashed = sharded.slot_weights_stacked(load_sharded_weights(
        prefix18, S, DEVICE), sg18)
    if not torch.equal(sharded.sssp_sharded_scan(sg18, hashed, 0, False)[0],
                       sharded.sssp_sharded_scan_hash(sg18, 0, False)[0]):
        raise AssertionError("SSSP on the stored hashed weights differs from "
                             "sssp_sharded_scan_hash")
    rev, dmask = sharded.pr_consts(ec18)
    hub18 = int(np.argmax(np.bincount(ec18.src_ids,
                                      minlength=ec18.vertices_count)))
    rng18 = np.random.default_rng(SEED + 1)
    roots18 = [int(r) for r in rng18.choice(np.flatnonzero(np.bincount(
        ec18.src_ids, minlength=ec18.vertices_count)), 32, replace=False)]
    hosts_b = sum(_nbytes(g) for g in ssg.shards)
    shard_b = max(_nbytes(g) for g in ssg.shards) + max(
        w.numel() * 4 for w in ssg.weights)
    # the copy alone: every shard to the card once, with nothing to run
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    streaming._sweep(ssg, lambda g, s: None, "copy")
    copy_s = time.perf_counter() - t1
    numbers["h2d_gb_s"] = ssg.h2d_bytes / copy_s / 1e9
    print(f"  streamed RMAT-{SCALE}: {S} slim shards, {hosts_b / 2**20:.1f} "
          f"MiB pinned on the host; one sweep of copies alone "
          f"{copy_s * 1e3:.2f} ms, {numbers['h2d_gb_s']:.2f} GB/s host to "
          f"device on {smi}")
    scases = [
        ("pagerank", lambda: (streaming.pagerank_streamed(
            ssg, rev, dmask, STREAM_ITERS),),
         lambda: (sharded.pagerank_sharded_scan(sg18, ec18, STREAM_ITERS),)),
        ("hits", lambda: streaming.hits_streamed(ssg, STREAM_ITERS // 2),
         lambda: sharded.hits_sharded_scan(sg18, STREAM_ITERS // 2)),
        ("msbfs", lambda: streaming.msbfs_streamed(ssg, roots18)[:1],
         lambda: (sharded.msbfs_sharded_scan(sg18, roots18),)),
        ("cc_hybrid", lambda: streaming.cc_hybrid_streamed(ssg, hub18)[:1],
         lambda: sharded.cc_hybrid_sharded_scan(sg18, hub18)[:1]),
        ("sssp", lambda: streaming.sssp_streamed(ssg, 0)[:1],
         lambda: sharded.sssp_sharded_scan(sg18, hashed, 0,
                                           partial=False)[:1])]
    for label, call, resident in scases:
        # the resident scan's peak above its start: its vertex state and
        # temporaries, which the streamed run holds too, beside its shards
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        want = resident()
        torch.cuda.synchronize()
        state_b = torch.cuda.max_memory_allocated() - before
        bound_mib = (2 * shard_b + state_b) / 2**20
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        n_sweeps, h2d = len(ssg.sweep_s), ssg.h2d_bytes
        t1 = time.perf_counter()
        got = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        peak = (torch.cuda.max_memory_allocated() - before) / 2**20
        n = {name: k.launches for name, k in kernels.items()}
        sweeps = ssg.sweep_s[n_sweeps:]
        dirs = 2 if label == "cc_hybrid" else 1
        count_check(f"{label}_streamed", n, dict(
            pull_reduce=dirs * S * len(sweeps),
            route_gather_finish=2 * dirs * S * len(sweeps)))
        for name in n:
            launches[PATHS17[2]][name] += n[name]
        for gt, wt in zip(got, want):
            if label in ("pagerank", "hits"):
                w_np = wt.cpu().numpy()
                if not np.allclose(gt.cpu().numpy(), w_np, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(w_np).max())):
                    raise AssertionError(f"{label}_streamed differs from the "
                                         f"resident scan")
            elif not torch.equal(gt, wt):
                raise AssertionError(f"{label}_streamed differs from the "
                                     f"resident scan")
        if ssg.peak_resident > 2 or peak > bound_mib:
            raise AssertionError(f"{label}_streamed: {ssg.peak_resident} "
                                 f"shards resident, peak {peak:.1f} MiB "
                                 f"against a bound of {bound_mib:.1f}")
        numbers[f"streamed_{label}"] = dict(
            wall_ms=wall * 1e3, sweeps=len(sweeps),
            sweep_ms=statistics.median(sweeps) * 1e3,
            gb_s=(ssg.h2d_bytes - h2d) / wall / 1e9, peak_mib=peak,
            bound_mib=bound_mib, pull_reduce=n["pull_reduce"])
        print(f"  {label}_streamed: equal to the resident scan; "
              f"{len(sweeps)} sweeps, {wall * 1e3:.1f} ms, sweep median "
              f"{numbers[f'streamed_{label}']['sweep_ms']:.2f} ms (min "
              f"{min(sweeps) * 1e3:.2f}, max {max(sweeps) * 1e3:.2f}), "
              f"{numbers[f'streamed_{label}']['gb_s']:.2f} GB/s copied over "
              f"the call; peak {peak:.1f} MiB above the state before it, "
              f"bound {bound_mib:.1f} MiB (two shards with weights "
              f"{2 * shard_b / 2**20:.1f} + the resident scan's state "
              f"{state_b / 2**20:.1f}); launches pull_reduce "
              f"{n['pull_reduce']}, route_gather_finish "
              f"{n['route_gather_finish']} on {smi}")
    del ssg

    # (d) the JAX package's slim shards, written and loaded in (b): every
    # rebuilt CSR against phase 16's full load of the same files, and the
    # scans over both
    full, jslim = kept["loaded18"], jslim18
    for s in range(S):
        got, want = jslim.shard(s), shard_build.slim_value_pull(full.shard(s))
        if not (got.slim and got.advance_route is None):
            raise AssertionError(f"JAX slim shard {s}: not loaded slim")
        for d in ("outgoing", "incoming"):
            for k in ("row_ptr", "col_idx", "degrees"):
                if not torch.equal(getattr(getattr(got, d), k),
                                   getattr(getattr(want, d), k)):
                    raise AssertionError(f"JAX slim shard {s}: rebuilt "
                                         f"{d}.{k} differs from the full "
                                         f"load's")
        if not torch.equal(got.in_route_slots, want.in_route_slots):
            raise AssertionError(f"JAX slim shard {s}: in_route_slots "
                                 f"differ from the full load's")
    for k in kernels.values():
        k.launches = 0
    for label, fn in (
            ("pagerank", lambda g: sharded.pagerank_sharded_scan(g, ec18,
                                                                 ITERS)),
            ("bfs", lambda g: sharded.bfs_sharded_scan(g, roots18[0])),
            ("sssp_hash", lambda g: sharded.sssp_sharded_scan_hash(
                g, roots18[0], True)[0])):
        if not torch.equal(fn(jslim), fn(full)):
            raise AssertionError(f"{label} on the JAX slim shards differs "
                                 f"from the full load's")
    n = {name: k.launches for name, k in kernels.items()}
    for name in n:
        launches[PATHS17[3]][name] += n[name]
    print(f"  JAX package's slim shards of RMAT-{SCALE} in {S}: written in "
          f"{numbers['jax_slim_write_s']:.2f} s; load_sharded_graph "
          f"{numbers['load_jax_slim_s']:.2f} s (CSRs rebuilt, while the "
          f"ranks of (b) ran) against phase 16's load of the full files "
          f"{p16['numbers']['load_s']:.2f} s, lane_shuffle {8 * S} "
          f"launches each as predicted; every CSR and in_route_slots equal "
          f"to the full load's; PageRank, BFS and hashed SSSP bit-equal "
          f"(their launches {n}) on {smi}")
    del full, jslim
    return dict(launches=launches, numbers=numbers)


TIER_SCALE, TIER_DEGREE, TIER_SHARDS = 20, 32, 8   # phase 18
TIER_PR_ITERS = 20
PATHS18 = (f"tier_resident_rmat{TIER_SCALE}", f"tier_streamed_rmat{TIER_SCALE}")


def _tier_edges(path: str, workers: int) -> str:
    """Python source that writes the builder's graph (rmat_fast from its
    seed, weighted) to `path` as src, dst, w: run in a process of its own,
    because rmat_fast forks and this one has a CUDA context."""
    return (f"import numpy as np\n"
            f"from vectorgraphlibrary_tpu_torch.io.generation import "
            f"rmat_fast\n"
            f"ec = rmat_fast({TIER_SCALE}, {TIER_DEGREE}, seed=42, "
            f"weighted=True, workers={workers})\n"
            f"np.savez({path!r}, src=ec.src_ids, dst=ec.dst_ids, "
            f"w=ec.weights)\n")


def _host_child(cmd: list, env: dict) -> tuple:
    """Start a host-only child (no CUDA: CUDA_VISIBLE_DEVICES is empty
    there) from the repository's root; -> (the process, its start time)."""
    return (subprocess.Popen(
        cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
        env=dict(os.environ, CUDA_VISIBLE_DEVICES="", **env),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        time.perf_counter())


def _host_done(label: str, child: tuple, timeout: int) -> tuple:
    """Wait for a _host_child; -> (its stdout, its wall seconds). Raises if
    it fails (and kills it past `timeout`)."""
    proc, t0 = child
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode != 0:
        raise AssertionError(f"{label} failed ({proc.returncode}):\n"
                             f"{out[-4000:]}\n{err[-4000:]}")
    return out, time.perf_counter() - t0


def _least_weight_matrix(src, dst, w, v: int):
    """scipy CSR matrix [v, v] of the edges (src, dst) in f64, a repeated
    edge keeping its least weight (csr_matrix would sum them)."""
    import scipy.sparse as sp
    key = src.astype(np.int64) * v + dst
    order = np.lexsort((w, key))
    first = np.ones(len(order), bool)
    first[1:] = key[order][1:] != key[order][:-1]
    keep = order[first]
    return sp.csr_matrix((w[keep].astype(np.float64),
                          (src[keep], dst[keep])), shape=(v, v))


def phase_tier(kernels: dict, smi: str) -> dict:
    """Phase 18: the large tier's path at RMAT-20/32 in 8 hash shards (module
    doc). -> {"launches": {path: counts}, "numbers": {...}}."""
    from scipy.sparse.csgraph import connected_components, dijkstra
    from vectorgraphlibrary_tpu_torch.apps import scale_tier
    from vectorgraphlibrary_tpu_torch.graph import persistence
    from vectorgraphlibrary_tpu_torch.io.edges_container import (
        EdgesContainer)
    from vectorgraphlibrary_tpu_torch.models import pr
    from vectorgraphlibrary_tpu_torch.parallel import sharded, streaming
    from vectorgraphlibrary_tpu_torch.runtime.timer import DeviceTimer
    from vectorgraphlibrary_tpu_torch.utils.verify import (
        verify_ranking_results)
    S, numbers = TIER_SHARDS, {}
    workers = min(S, os.cpu_count() or 1)
    cache = tempfile.TemporaryDirectory()
    env = dict(VGL_S25_SCALE=str(TIER_SCALE), VGL_S25_DEGREE=str(TIER_DEGREE),
               VGL_S25_SHARDS=str(S), VGL_S25_WORKERS=str(workers),
               VGL_S25_CACHE=cache.name, VGL_S25_GEN="rmat_fast")
    coo = os.path.join(cache.name, "coo.npz")
    # the builder, and beside it the graph again for the oracles
    builder = _host_child([sys.executable, "-m",
                           "vectorgraphlibrary_tpu_torch.apps.build_scale25"],
                          env)
    regen = _host_child([sys.executable, "-c", _tier_edges(coo, workers)], {})
    out, wall = _host_done("apps/build_scale25.py", builder, 900)
    _, gen_wall = _host_done("rmat_fast", regen, 600)
    built = json.loads(out.strip().splitlines()[-1])
    numbers["builder"] = dict(built, wall_s=wall)
    print(f"  build_scale25 (a process of its own, {workers} workers, "
          f"rmat_fast): generate {built['gen_s']:.2f} s, build "
          f"{built['build_s']:.2f} s, {built['bytes_on_disk'] / 2**20:.1f} "
          f"MiB on disk, host {built['nproc']} cores, "
          f"{built['mem_total_gib']} GiB")
    prefix = built["built"]
    with open(f"{prefix}.meta.json") as f:
        meta = json.load(f)
    eps = meta["edges_per_shard"]
    e = TIER_DEGREE << TIER_SCALE
    if meta["e"] != e or sum(eps) != e or len(eps) != S \
            or meta["partition"] != "dst-hash":
        raise AssertionError(f"tier meta: {meta}")
    if max(eps) >= 1.5 * min(eps):
        raise AssertionError(f"tier shards unbalanced: {eps}")
    with np.load(coo) as z:
        ec = EdgesContainer(z["src"], z["dst"], 1 << TIER_SCALE, z["w"])
    v = ec.vertices_count
    consts = scale_tier.load_consts(prefix, meta["v_pad"], DEVICE)
    rev, dmask = sharded.pr_consts(ec)
    if not (np.array_equal(rev, consts.rev)
            and np.array_equal(dmask, consts.dmask)):
        raise AssertionError("the builder's prconsts differ from the graph's")
    hub = consts.hub
    roots = [int(r) for r in np.random.default_rng(SEED + 2).choice(
        np.flatnonzero(consts.rev > 0), 32, replace=False)]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sg = persistence.load_sharded_graph(prefix, DEVICE)
    weights = sharded.slot_weights_stacked(
        persistence.load_sharded_weights(prefix, S, DEVICE), sg)
    torch.cuda.synchronize()
    numbers["resident_load_s"] = time.perf_counter() - t0
    numbers["resident_bytes"] = (
        sum(scale_tier.tensor_bytes(g) for g in sg.shards)
        + scale_tier.tensor_bytes(weights))
    t0 = time.perf_counter()
    ssg = streaming.load_streamed(prefix, weights=True, device=DEVICE)
    numbers["streamed_load_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    streaming._sweep(ssg, lambda g, s: None, "copy")
    numbers["h2d_gb_s"] = ssg.h2d_bytes / (time.perf_counter() - t0) / 1e9
    print(f"  loaded: resident {numbers['resident_bytes'] / 2**20:.1f} MiB "
          f"on the card in {numbers['resident_load_s']:.2f} s; streamed in "
          f"{numbers['streamed_load_s']:.2f} s, copies at "
          f"{numbers['h2d_gb_s']:.2f} GB/s host to device on {smi}")

    # (name, resident call, streamed call, edges a call traverses)
    cases = [
        ("pagerank",
         lambda: (sharded.pagerank_sharded_scan_consts(
             sg, consts.rev, consts.dmask, TIER_PR_ITERS),),
         lambda: (streaming.pagerank_streamed(
             ssg, consts.rev, consts.dmask, TIER_PR_ITERS),),
         e * TIER_PR_ITERS),
        ("sssp",
         lambda: sharded.sssp_sharded_scan(sg, weights, hub,
                                           partial=False)[:1],
         lambda: streaming.sssp_streamed(ssg, hub)[:1], e),
        ("msbfs", lambda: (sharded.msbfs_sharded_scan(sg, roots),),
         lambda: streaming.msbfs_streamed(ssg, roots)[:1], None),
        ("cc_hybrid", lambda: sharded.cc_hybrid_sharded_scan(sg, hub)[:1],
         lambda: streaming.cc_hybrid_streamed(ssg, hub)[:1], e)]
    launches = {p: dict.fromkeys(kernels, 0) for p in PATHS18}
    results = {}
    for label, resident, streamed, edges in cases:
        got = {}
        for path, call in zip(PATHS18, (resident, streamed)):
            for k in kernels.values():
                k.launches = 0
            torch.cuda.synchronize()
            n_sweeps = len(ssg.sweep_s)
            got[path] = call()
            torch.cuda.synchronize()
            n = {name: k.launches for name, k in kernels.items()}
            for name in n:
                launches[path][name] += n[name]
            if n["pull_reduce"] == 0 or n["route_gather_finish"] == 0 \
                    or any(c for name, c in n.items() if name not in (
                        "pull_reduce", "route_gather_finish")):
                raise AssertionError(f"tier {label} {path}: launches {n}")
            if path == PATHS18[1]:
                sweeps = len(ssg.sweep_s) - n_sweeps
                dirs = 2 if label == "cc_hybrid" else 1
                if n != dict(dict.fromkeys(kernels, 0),
                             pull_reduce=dirs * S * sweeps,
                             route_gather_finish=2 * dirs * S * sweeps):
                    raise AssertionError(f"tier {label} streamed: launches "
                                         f"{n} for {sweeps} sweeps")
            elif label == "pagerank" and n != dict(
                    dict.fromkeys(kernels, 0),
                    pull_reduce=S * TIER_PR_ITERS,
                    route_gather_finish=2 * S * TIER_PR_ITERS):
                raise AssertionError(f"tier pagerank resident: launches {n}")
        for a, b in zip(*got.values()):
            if label == "pagerank" and not torch.equal(a, b):
                if not np.allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=1e-5, atol=0):
                    raise AssertionError("tier pagerank: streamed differs "
                                         "from resident")
            elif label != "pagerank" and not torch.equal(a, b):
                raise AssertionError(f"tier {label}: streamed differs from "
                                     f"resident")
        results[label] = got[PATHS18[0]][0]
        rates = {}
        for path, call in zip(PATHS18, (resident, streamed)):
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(3):
                timer = DeviceTimer(DEVICE).start()
                res = call()
                times.append(timer.stop(res))
            if edges is None:        # MS-BFS: the roots' traversed edges
                edges = scale_tier.traversed_edges(results["msbfs"],
                                                   consts.outdeg)
            t = statistics.median(times)
            rates[path] = dict(ms=t * 1e3, min_ms=min(times) * 1e3,
                               max_ms=max(times) * 1e3,
                               mteps=edges / t / 1e6,
                               peak_mib=torch.cuda.max_memory_allocated()
                               / 2**20)
        numbers[label] = dict(rates, edges=edges)
        print(f"  {label}: resident and streamed equal; "
              + "; ".join(f"{p} median {r['ms']:.2f} ms (min "
                          f"{r['min_ms']:.2f}, max {r['max_ms']:.2f}), "
                          f"{r['mteps']:.1f} MTEPS, peak {r['peak_mib']:.1f} "
                          f"MiB" for p, r in rates.items()) + f" on {smi}")

    # the oracles, on the host
    want = pr.seq_page_rank(ec, max_iterations=TIER_PR_ITERS,
                            use_convergence=False)
    errors = verify_ranking_results(results["pagerank"][:v].cpu().numpy(),
                                    want)
    if errors:
        raise AssertionError(f"tier pagerank: error count {errors}")
    mat = _least_weight_matrix(ec.src_ids, ec.dst_ids, ec.weights, v)
    t0 = time.perf_counter()
    want_d = dijkstra(mat, directed=True, indices=hub)
    got_d = results["sssp"][:v].cpu().numpy().astype(np.float64)
    if not np.array_equal(np.isinf(got_d), np.isinf(want_d)) or not \
            np.allclose(got_d[np.isfinite(want_d)],
                        want_d[np.isfinite(want_d)], rtol=1e-5, atol=0):
        raise AssertionError("tier sssp: distances differ from scipy's "
                             "dijkstra")
    n_comp, _ = connected_components(mat, directed=True, connection="weak")
    got_comp = int(torch.unique(results["cc_hybrid"][:v]).numel())
    if got_comp != n_comp:
        raise AssertionError(f"tier cc: {got_comp} components, scipy "
                             f"{n_comp}")
    numbers.update(components=n_comp, oracle_s=time.perf_counter() - t0,
                   generate_again_s=gen_wall,
                   reached=int(np.isfinite(want_d).sum()))
    print(f"  oracles: PageRank error count 0 against seq_page_rank, SSSP "
          f"from {hub} equal to scipy's dijkstra ({numbers['reached']} "
          f"reached, rtol 1e-5), {n_comp} weak components as scipy's; "
          f"launches {launches}")
    del ssg, sg, weights
    cache.cleanup()
    return {"launches": launches, "numbers": numbers}


S24_SCALE, S24_DEGREE = 20, 16   # phase 19: the scale-24 path cut from 24
PATHS19 = (f"scale24_rmat{S24_SCALE}", f"crosscheck_rmat{S24_SCALE}")


def _shard_edges_hashed(sg) -> tuple:
    """Every edge of a loaded sharded graph as (src, dst, w) in ORIGINAL
    ids, read back from each shard's incoming CSR (its rows and columns in
    the GATHER ordering, mapped by the shard's own vertex route), with the
    slot-hash weight that sssp_sharded_scan_hash gives it."""
    from vectorgraphlibrary_tpu_torch.models import common
    from vectorgraphlibrary_tpu_torch.models.common import TraversalDirection
    from vectorgraphlibrary_tpu_torch.parallel import sharded
    fn = sharded.slot_hash_weight_fn(sharded.route_slot_count(sg.shard(0)))
    ids = torch.arange(sg.v_pad, dtype=torch.int32, device=sg.device)
    src, dst, w = [], [], []
    for s, g in enumerate(sg.shards):
        orig = common.to_direction(g, ids, TraversalDirection.ORIGINAL,
                                   TraversalDirection.GATHER)
        e = g.incoming.e
        rows = torch.repeat_interleave(
            torch.arange(sg.v_pad, device=sg.device),
            g.incoming.row_ptr.diff().long())
        dst.append(orig[rows].cpu().numpy())
        src.append(orig[g.incoming.col_idx[:e].long()].cpu().numpy())
        w.append(fn(s, g).flat[:e].cpu().numpy())
    return tuple(np.concatenate(a) for a in (src, dst, w))


def phase_scale24(kernels: dict, ec, graph, smi: str) -> dict:
    """Phase 19: the scale-24 tier's path at RMAT-20/16 (module doc) on
    the phase-6 graph `ec` (imported unsharded as `graph`). -> {"launches":
    {path: counts}, "numbers": {...}}."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components, dijkstra
    from vectorgraphlibrary_tpu_torch.apps import (bench_scale24,
                                                   build_scale24,
                                                   crosscheck_scale20)
    from vectorgraphlibrary_tpu_torch.models import bfs, common, hits, pr
    from vectorgraphlibrary_tpu_torch.models.common import TraversalDirection
    from vectorgraphlibrary_tpu_torch.utils.verify import (
        verify_ranking_results, verify_results)
    numbers, v = {}, ec.vertices_count
    if (v.bit_length() - 1, ec.edges_count // v) != (S24_SCALE, S24_DEGREE):
        raise AssertionError("phase 19 runs on the phase-6 graph")
    cache = tempfile.TemporaryDirectory()
    builder = _host_child(
        [sys.executable, "-m", "vectorgraphlibrary_tpu_torch.apps.build_scale24"],
        dict(VGL_S24_SCALE=str(S24_SCALE), VGL_S24_DEGREE=str(S24_DEGREE),
             VGL_S24_CACHE=cache.name))
    # the host oracles, beside the builder
    t0 = time.perf_counter()
    want_shards = build_scale24.shard_count(ec)
    roots = bench_scale24.roots_of(v)
    want_pr = pr.seq_page_rank(ec, max_iterations=bench_scale24.PR_ITERS,
                               use_convergence=False)
    want_lv = bfs.seq_top_down(ec, [bench_scale24.SOURCE, int(roots[0]),
                                    int(roots[1])])
    n_comp = connected_components(sp.csr_matrix(
        (np.ones(ec.edges_count, bool), (ec.src_ids, ec.dst_ids)),
        shape=(v, v)), directed=True, connection="weak")[0]
    numbers["host_oracles_s"] = time.perf_counter() - t0
    out, wall = _host_done("apps/build_scale24.py", builder, 600)
    built = json.loads(out.strip().splitlines()[-1])
    numbers["builder"] = dict(built, wall_s=wall)
    prefix = built["built"]
    with open(f"{prefix}.meta.json") as f:
        meta = json.load(f)
    S, eps = meta["n_shards"], meta["edges_per_shard"]
    if S != want_shards or built["shards"] != S or meta["e"] != ec.edges_count \
            or sum(eps) != meta["e"] or meta["partition"] != "dst-mod" \
            or eps != np.bincount(ec.dst_ids % S, minlength=S).tolist():
        raise AssertionError(f"scale-24 meta {meta}, want {want_shards} "
                             f"dst-mod shards")
    print(f"  build_scale24 (a process of its own): {S} dst % S shards as "
          f"the JAX script's rule picks, edges {eps} (sum |E|), generate "
          f"{built['gen_s']:.2f} s, build {built['build_s']:.2f} s, peak RSS "
          f"{built['shard_peak_rss_gib']} GiB a worker, "
          f"{built['bytes_on_disk'] / 2**20:.1f} MiB on disk; host oracles "
          f"{numbers['host_oracles_s']:.2f} s beside it")

    sg, consts, load_row = bench_scale24.load(prefix, DEVICE)
    numbers["load"] = load_row
    launches = {p: dict.fromkeys(kernels, 0) for p in PATHS19}
    results, rows = {}, []
    for name in bench_scale24.ROWS:
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        got = bench_scale24.measure(sg, consts, DEVICE, (name,), results)
        torch.cuda.synchronize()
        n = {kn: k.launches for kn, k in kernels.items()}
        pulls = S * (got[0]["warmup_pull_steps"]
                     + bench_scale24.REPS * got[0]["pull_steps"])
        routes = (3 if name == "sssp" else 2) * pulls
        if n != dict(dict.fromkeys(kernels, 0), pull_reduce=pulls,
                     route_gather_finish=routes):
            raise AssertionError(f"scale-24 {name}: launches {n}, want "
                                 f"{pulls} pulls and {routes} routes")
        for kn in n:
            launches[PATHS19[0]][kn] += n[kn]
        rows += got
    numbers["rows"] = rows
    by = {r["metric"]: r for r in rows}
    s = f"rmat{S24_SCALE}"

    # the checks
    errors = verify_ranking_results(results["pagerank"][:v].cpu().numpy(),
                                    want_pr)
    if errors:
        raise AssertionError(f"scale-24 pagerank: error count {errors}")
    if not np.array_equal(results["bfs"][:v].cpu().numpy(), want_lv[0]):
        raise AssertionError("scale-24 bfs: levels differ from the host BFS")
    g_ms = bfs.vgl_msbfs(graph, roots).values
    want_ms = torch.stack([common.to_direction(
        graph, g_ms[i], TraversalDirection.SCATTER,
        TraversalDirection.ORIGINAL) for i in range(len(roots))])[:, :v]
    got_ms = results["msbfs"][:, :v].to(torch.int32)
    if not torch.equal(got_ms, want_ms.to(torch.int32)):
        raise AssertionError("scale-24 msbfs: levels differ from vgl_msbfs")
    if not np.array_equal(got_ms[:2].cpu().numpy(), want_lv[1:]):
        raise AssertionError("scale-24 msbfs: levels differ from the host "
                             "BFS")
    auth, hub = hits.vgl_hits(graph, iterations=bench_scale24.HITS_ITERS)
    for label, a, b in (("auth", results["hits"][0], auth.values),
                        ("hub", results["hits"][1], hub.values)):
        a, b = a[:v].cpu().numpy(), b[:v].cpu().numpy()
        if not np.allclose(a, b, rtol=1e-5, atol=1e-6 * np.abs(b).max()):
            raise AssertionError(f"scale-24 hits {label}: differs from "
                                 f"vgl_hits")
    t0 = time.perf_counter()
    src, dst, w = _shard_edges_hashed(sg)
    want_d = dijkstra(_least_weight_matrix(src, dst, w, v), directed=True,
                      indices=bench_scale24.SOURCE)
    errors = verify_results(results["sssp"][0][:v].cpu().numpy(), want_d)
    if errors or len(src) != ec.edges_count:
        raise AssertionError(f"scale-24 sssp: error count {errors} against "
                             f"the host Dijkstra on the hashed weights")
    numbers["dijkstra_s"] = time.perf_counter() - t0
    got_comp = by[f"cc_sv_{s}_mteps"]["components"]
    if got_comp != n_comp:
        raise AssertionError(f"scale-24 cc: {got_comp} components, scipy "
                             f"{n_comp}")
    del src, dst, w

    # the cross-check, on the same graph
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cross = crosscheck_scale20.crosscheck(ec, bench_scale24.PR_ITERS, DEVICE,
                                          graph=graph)
    torch.cuda.synchronize()
    launches[PATHS19[1]] = {kn: k.launches for kn, k in kernels.items()}
    numbers["crosscheck"] = dict(cross, seconds=time.perf_counter() - t0)
    if not cross["ok"] or launches[PATHS19[1]]["pull_reduce"] == 0 \
            or launches[PATHS19[1]]["route_gather_finish"] == 0:
        raise AssertionError(f"scale-24 cross-check: {cross}, launches "
                             f"{launches[PATHS19[1]]}")
    numbers.update(components=n_comp, reached=by[f"bfs_{s}_gteps"]["reached"])
    print("  rows (median of 3 after a warm-up, DeviceTimer): " + "; ".join(
        f"{r['metric']} {r['value']:.2f} {r['unit']} ({r['seconds'] * 1e3:.2f}"
        f" ms, min {r['seconds_min'] * 1e3:.2f}, max "
        f"{r['seconds_max'] * 1e3:.2f}, peak "
        f"{r['peak_device_bytes'] / 2**20:.1f} MiB)" for r in rows)
          + f" on {smi}")
    print(f"  checks: PageRank error count 0 against seq_page_rank; BFS from "
          f"{bench_scale24.SOURCE} equal to the host BFS "
          f"({numbers['reached']} reached); MS-BFS equal to vgl_msbfs for "
          f"{len(roots)} roots and to the host BFS for 2; HITS within rtol "
          f"1e-5 of vgl_hits; hashed SSSP error count 0 against scipy's "
          f"dijkstra on {len(want_d)} vertices ({numbers['dijkstra_s']:.2f} "
          f"s); {n_comp} weak components as scipy's; cross-check ok "
          f"(max abs errors {cross['max_abs_err_scan_vs_oracle']:.3g}, "
          f"{cross['max_abs_err_single_vs_oracle']:.3g}); launches "
          f"{launches}")
    del sg
    cache.cleanup()
    return {"launches": launches, "numbers": numbers}


# phase 20: lj-replica (apps/make_lj_replica.py) at 1/16 of its vertices,
# edges and degree cap; |E| stays above SSSP's 2^22 all-active threshold
LJ_V, LJ_E, LJ_MAX_DEG = 302_973, 4_312_110, 1_250
PATHS20 = tuple(f"lj_{row}_v{LJ_V}" for row in ("sssp", "cc", "msbfs"))
# the kernels each row must launch on its path
LJ_KERNELS = {"sssp": ("pull_reduce", "route_gather_finish", "scatter_combine"),
              "cc": ("pull_reduce", "route_gather_finish"),
              "msbfs": ("pull_reduce", "route_gather_finish")}
LJ_PUSH_MESSAGES = 1 << 16      # partial SSSP's largest push capacity


def phase_lj(kernels: dict, rg, pl, scm, smi: str) -> dict:
    """Phase 20: the LiveJournal-scale path at 1/16 (module doc). ->
    {"launches": {path: counts}, "numbers": {...}, "pull", "route",
    "scatter": each kernel's error against its plain version and its
    times at this graph's shapes}."""
    from vectorgraphlibrary_tpu_torch.apps import (bench_lj, exp_lj_oracle,
                                                   make_lj_replica)
    from vectorgraphlibrary_tpu_torch.models import sssp
    numbers = {}
    t0 = time.perf_counter()
    ec = make_lj_replica.replica(LJ_V, LJ_E, LJ_MAX_DEG)
    numbers["gen_s"] = time.perf_counter() - t0
    if ec.edges_count < sssp._AA_EDGE_THRESHOLD:
        raise AssertionError("phase 20's SSSP must take the partial path")
    wec, graph, ea, numbers["import"] = bench_lj.load(ec, DEVICE)
    deg = bench_lj.out_degrees(wec)
    t0 = time.perf_counter()
    want = exp_lj_oracle.oracle(wec, bench_lj.sources(deg)[1],
                                bench_lj.roots(deg)[1])
    numbers["oracle"] = exp_lj_oracle.summary(want)
    numbers["oracle_s"] = time.perf_counter() - t0
    print(f"  lj-replica at 1/16: |V| {LJ_V:,}, |E| {LJ_E:,}, cap "
          f"{LJ_MAX_DEG:,}, generated in {numbers['gen_s']:.2f} s, imported "
          f"in {numbers['import']['value']:.2f} s (advance route "
          f"{numbers['import']['advance_route']}, "
          f"{numbers['import']['graph_bytes'] / 2**20:.1f} MiB of graph and "
          f"{numbers['import']['weight_bytes'] / 2**20:.1f} MiB of weights on "
          f"the card, v_pad {graph.v_pad:,}); host oracle "
          f"{numbers['oracle_s']:.2f} s")

    launches = {}
    results, rows = {}, []
    calls = 1 + bench_lj.REPS          # each row's warm-up and timed calls
    for name, path in zip(bench_lj.ROWS, PATHS20):
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        rows += bench_lj.measure(wec, graph, ea, DEVICE, (name,), results)
        torch.cuda.synchronize()
        n = launches[path] = {kn: k.launches for kn, k in kernels.items()}
        pulls, routes = n["pull_reduce"], n["route_gather_finish"]
        # the path's rules: the partial SSSP's push sweep 2 scatters (the
        # owner mark, the f32 min) and 3 routes, and 1 route a run; CC's
        # and MS-BFS's pulls 2 routes each; MS-BFS one pull per level of
        # each word (bench_lj.msbfs_pulls)
        if name == "sssp":
            pushes = n["scatter_combine"] // 2
            ok = n["scatter_combine"] == 2 * pushes and \
                routes == 3 * pushes + calls * bench_lj.N_SOURCES
        else:
            ok = routes == 2 * pulls
        if name == "msbfs":
            want_pulls = rows[-1]["pulls"]["warmup"] + \
                bench_lj.REPS * rows[-1]["pulls"]["timed"]
            ok = ok and pulls == want_pulls
        ok = ok and all(n[kn] > 0 for kn in LJ_KERNELS[name]) and not any(
            c for kn, c in n.items() if kn not in LJ_KERNELS[name])
        if not ok:
            raise AssertionError(f"lj {name}: launches {n} break the path's "
                                 f"rules (row {rows[-1]})")
    numbers["rows"] = rows
    check = bench_lj.check(wec, graph, results, want)
    numbers["check"] = check
    if not check["ok"]:
        raise AssertionError(f"lj: the rows differ from the host oracle: "
                             f"{check}")

    # the path's kernels against their plain versions at this graph's shapes
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 20)
    dist = results["sssp"][0].contiguous()
    words = torch.randint(-2**31, 2**31 - 1, (graph.v_pad,), generator=gen,
                          device=DEVICE, dtype=torch.int32)
    dg = graph.incoming
    pull = {"max_err": max(
        _pull_check(pl, "lj 1/16 G f32 min of x + w", dg, dist, "min", False,
                    ea.incoming.flat, "add"),
        _pull_check(pl, "lj 1/16 G i32 or", dg, words, "or", False),
        _pull_check(pl, "lj 1/16 G int8 any01", dg,
                    (words & 1).to(torch.int8), "any01", False))}
    # torch has no min-plus or or-reduce SpMV: no one-call PyTorch
    pull["f32_min_of_x_plus_w"] = dict(_pull_times(
        pl, dg, dist, "min", False, "lj 1/16 G f32 min of x + w", smi,
        ea.incoming.flat, "add"), library_ms=None)
    pull["i32_or"] = dict(_pull_times(pl, dg, words, "or", False,
                                      "lj 1/16 G i32 or", smi),
                          library_ms=None)
    idx = graph.vertex_route_s_from_g.fwd_idx
    route = {"max_err": max(_check(rg, "lj 1/16 vertex route i32", words,
                                   idx, {}),
                            _check(rg, "lj 1/16 vertex route f32",
                                   torch.where(torch.isfinite(dist), dist,
                                               -1.0), idx, {}))}
    route.update(
        ms=_median3("route_gather_finish lj 1/16 vertex route i32, kernel",
                    "ms", [_cuda_ms(lambda: rg.route_gather_finish(
                        words, idx)) for _ in range(3)], smi),
        plain_ms=_median3("route_gather_finish lj 1/16 vertex route i32, "
                          "plain", "ms", [_cuda_ms(
                              lambda: rg.route_gather_finish_ref(words, idx))
                              for _ in range(3)], smi),
        library_ms=_median3("lj 1/16 vertex route i32, index_select", "ms",
                            [_cuda_ms(lambda: torch.index_select(
                                words, 0, idx)) for _ in range(3)], smi),
        bound_ms=_bound_ms(3 * 4 * graph.v_pad))
    sidx = torch.randint(0, graph.v_pad + graph.v_pad // 8,
                         (LJ_PUSH_MESSAGES,), generator=gen, device=DEVICE,
                         dtype=torch.int32)
    msg = torch.rand(LJ_PUSH_MESSAGES, generator=gen, device=DEVICE) * 300
    got = scm.scatter_combine(dist, sidx, msg, "min")
    ref = scm.scatter_combine_ref(dist, sidx, msg, "min")
    if not torch.equal(_bits(got), _bits(ref)):
        raise AssertionError("scatter_combine f32 min != plain version at "
                             "lj 1/16")
    scatter = {"max_err": torch.where(got == ref, 0.0, (
        got.double() - ref.double()).abs()).max().item()}
    keep = sidx < graph.v_pad
    idx_in, msg_in = sidx[keep].long(), msg[keep]
    scatter.update(
        ms=_median3("scatter_combine lj 1/16 f32 min, kernel", "ms",
                    [_cuda_ms(lambda: scm.scatter_combine(
                        dist, sidx, msg, "min")) for _ in range(3)], smi),
        plain_ms=_median3("scatter_combine lj 1/16 f32 min, plain", "ms",
                          [_cuda_ms(lambda: scm.scatter_combine_ref(
                              dist, sidx, msg, "min")) for _ in range(3)],
                          smi),
        library_ms=_median3("lj 1/16 f32 min, scatter_reduce", "ms",
                            [_cuda_ms(lambda: torch.scatter_reduce(
                                dist, 0, idx_in, msg_in, "amin"))
                             for _ in range(3)], smi),
        # the target copied (read and written), each message's index and
        # value read
        bound_ms=_bound_ms(2 * 4 * graph.v_pad + 8 * LJ_PUSH_MESSAGES))
    print(f"  scatter_combine lj 1/16 f32 min, {LJ_PUSH_MESSAGES} messages "
          f"into {graph.v_pad:,}: bit-exact, bound {scatter['bound_ms']:.4f} "
          f"ms")
    print("  rows (median of 3 after a warm-up, DeviceTimer): " + "; ".join(
        f"{r['metric']} {r['value']:.2f} {r['unit']} ({r['seconds'] * 1e3:.2f}"
        f" ms, min {r['seconds_min'] * 1e3:.2f}, max "
        f"{r['seconds_max'] * 1e3:.2f}, peak "
        f"{r['peak_device_bytes'] / 2**20:.1f} MiB)" for r in rows)
          + f" on {smi}")
    print(f"  checks against the host oracle: {check['components'][1]} "
          f"components, the {bench_lj.N_HUBS} CC runs' labels equal (error "
          f"counts {check['cc_errors']}), reached sets of "
          f"{bench_lj.N_ROOTS} roots and "
          f"{check['edges_traversed'][1]:,} traversed edges equal, SSSP error "
          f"counts {check['sssp_errors']}; launches {launches}")
    return {"launches": launches, "numbers": numbers, "pull": pull,
            "route": route, "scatter": scatter}


PRIM_REPS = 3        # profile_graph_primitives' default
UBENCH_K = 5


def _prim_rows(stats) -> dict:
    """The per-primitive table's numbers (print_timers_stats' columns)."""
    rows = {}
    for name, st in stats.stats.items():
        gbps = st.bytes_requested / st.wall_s / 1e9
        rows[name] = dict(ms=st.wall_s * 1e3, gbps=gbps,
                          roof_pct=100 * gbps / stats.hbm_roofline_gbps,
                          mteps=st.edges_visited / st.wall_s / 1e6,
                          bytes=st.bytes_requested, calls=st.calls)
    return rows


def _check_rows(label: str, rows: dict, want_rows: set) -> None:
    from vectorgraphlibrary_tpu_torch.runtime.perf_stats import H100_HBM_GBPS
    if set(rows) != want_rows:
        raise AssertionError(f"{label}: rows {sorted(rows)}, expected "
                             f"{sorted(want_rows)}")
    over = {n: r["gbps"] for n, r in rows.items()
            if not 0 < r["gbps"] <= H100_HBM_GBPS}
    if over:
        raise AssertionError(f"{label}: rows above the card's "
                             f"{H100_HBM_GBPS} GB/s (a wrong bytes model or "
                             f"a wrong subtraction): {over}")


def phase_measurement(kernels: dict, pr_graph, bfs_graph, bfs_ea,
                      smi: str) -> dict:
    """The measurement runtime on the card: profile_graph_primitives on the
    RMAT-18 graph and on the weighted RMAT-20 graph (each row at or under
    3,350 GB/s, reps + 1 launches of route_gather_finish and twice that of
    pull_reduce and scatter_combine), the PageRank app end to end through
    run_app (-s 18 -e 32 -it 3 -check: error count 0 per round, AVG_PERF,
    the table), ubench_prims with a small K (its JSON line) and the
    autotuner's samples on the card (its picks)."""
    from vectorgraphlibrary_tpu_torch.apps import pr as pr_app
    from vectorgraphlibrary_tpu_torch.apps import ubench_prims
    from vectorgraphlibrary_tpu_torch.apps.app_common import run_app
    from vectorgraphlibrary_tpu_torch.runtime import prim_profile
    from vectorgraphlibrary_tpu_torch.runtime.perf_stats import (
        PerformanceStats, performance_stats)
    from vectorgraphlibrary_tpu_torch.utils import autotuner
    base_rows = {"reorder (vertex route)", "advance (pull add)",
                 "advance (push sparse)", "generate_new_frontier"}
    per_pass = dict(route_gather_finish=PRIM_REPS + 1,
                    pull_reduce=2 * (PRIM_REPS + 1),
                    scatter_combine=2 * (PRIM_REPS + 1))
    launches, tables = {}, {}
    for label, graph, w, min_row in (
            (f"prim_rmat{SCALE}", pr_graph, None, "advance (pull min)"),
            (f"prim_rmat{BFS_SCALE}_weighted", bfs_graph, bfs_ea,
             "advance (pull min+w)")):
        totals = dict.fromkeys(kernels, 0)
        stats = PerformanceStats()
        _counted(kernels, totals, label,
                 lambda: prim_profile.profile_graph_primitives(
                     graph, w, stats=stats, reps=PRIM_REPS), per_pass)
        print(f"  {label}: the per-primitive table on {smi}:")
        stats.print_timers_stats()
        rows = _prim_rows(stats)
        _check_rows(label, rows, base_rows | {min_row})
        launches[label], tables[label] = totals, rows

    # the slice's path end to end: the app as a user runs it
    argv = ["-s", str(SCALE), "-e", str(DEGREE), "-it", "3", "-check",
            "-dev", DEVICE]
    label = f"app_pr_rmat{SCALE}"
    totals = dict.fromkeys(kernels, 0)
    buf = []

    def app():
        import io
        out = io.StringIO()
        try:
            with contextlib.redirect_stdout(out):
                rc = run_app("pr", pr_app.run_round, pr_app.check_round,
                             needs_source=False, argv=argv)
        finally:
            buf.append(out.getvalue())
            print(buf[0], end="")
        return rc
    # per round (warmup + 3) one PageRank of ITERS pulls and one vertex
    # route, per checked round one route back to the original order; the
    # profiling pass as above
    rc = _counted(kernels, totals, f"{label} (pr {' '.join(argv)})", app,
                  dict(pull_reduce=4 * pr_app._PR_ITERS
                       + per_pass["pull_reduce"],
                       route_gather_finish=4 + 3
                       + per_pass["route_gather_finish"],
                       scatter_combine=per_pass["scatter_combine"]))
    out = buf[0]
    errors = [int(ln.split("error count:")[1]) for ln in out.splitlines()
              if "error count:" in ln]
    if rc != 0 or errors != [0, 0, 0]:
        raise AssertionError(f"{label}: rc {rc}, error counts {errors}")
    if not any(ln.startswith("AVG_PERF:") for ln in out.splitlines()):
        raise AssertionError(f"{label}: no AVG_PERF line")
    app_rows = _prim_rows(performance_stats)
    _check_rows(label, app_rows, base_rows | {"advance (pull min)"})
    launches[label], tables[label] = totals, app_rows
    for name in ("route_gather_finish", "pull_reduce", "scatter_combine"):
        if not all(launches[p][name] for p in launches):
            raise AssertionError(f"{name} was not launched on every path "
                                 f"of this phase: {launches}")

    t0 = time.perf_counter()
    bench = ubench_prims.run(k=UBENCH_K, device=DEVICE)
    print(f"  ubench_prims (K = {UBENCH_K}, {time.perf_counter() - t0:.1f} "
          f"s) on {smi}:")
    print(json.dumps(bench))

    t0 = time.perf_counter()
    tuner = autotuner.collect_samples(scales=(12,), edge_factors=(8,),
                                      device=DEVICE)
    picks = [dict(graph=f"{kind}-12-8", **best)
             for kind, (_, best) in zip(("rmat", "ru"), tuner.samples)]
    print(f"  autotuner samples on the card "
          f"({time.perf_counter() - t0:.1f} s), picks: {json.dumps(picks)} "
          f"on {smi}")
    return dict(launches=launches, tables=tables, ubench=bench,
                autotuner_picks=picks)


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.manual_seed(SEED)
    from vectorgraphlibrary_tpu_torch.ops.cuda import and_popcount as ap
    from vectorgraphlibrary_tpu_torch.ops.cuda import build
    from vectorgraphlibrary_tpu_torch.ops.cuda import lane_shuffle as ls
    from vectorgraphlibrary_tpu_torch.ops.cuda import pull_reduce as pl
    from vectorgraphlibrary_tpu_torch.ops.cuda import pull_rows as prw
    from vectorgraphlibrary_tpu_torch.ops.cuda import push_expand as pe
    from vectorgraphlibrary_tpu_torch.ops.cuda import route_gather as rg
    from vectorgraphlibrary_tpu_torch.ops.cuda import scatter_combine as scm

    name = torch.cuda.get_device_name(0)
    smi = _smi()
    print(f"[1/20] device: {name} ({torch.cuda.device_count()} visible); "
          f"nvidia-smi: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")

    from concurrent.futures import ThreadPoolExecutor
    from vectorgraphlibrary_tpu_torch.apps import exp_route
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        # the route kernel's first design, the yardstick of phases 4 and 9,
        # built beside the library
        first = pool.submit(exp_route.first_design)
        build.load_library()
        first.result()
    ptxas = [ln.strip() for ln in build.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[2/20] build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{build.build_seconds:.2f} s, one process per source, sm_90a); "
          f"ptxas: " + " | ".join(ptxas))

    print(f"  ({time.perf_counter() - t_start:.1f} s since the start)")
    print("[3/20] kernel: route_gather_finish vs plain version, n = 2^24")
    max_err, rand_ms, rand_plain_ms = phase_kernel(rg)

    print(f"  ({time.perf_counter() - t_start:.1f} s since the start)")
    print(f"[4/20] slice: PageRank on RMAT-{SCALE}, and pull_reduce vs plain "
          f"version on its graph")
    prr = phase_pagerank(rg, pl, smi)
    prr["route"]["max_err"] = max(max_err, prr["route"]["max_err"])

    print(f"  ({time.perf_counter() - t_start:.1f} s since the start)")
    print(f"[5/20] kernel: scatter_combine vs plain version, V = 2^20, and "
          f"push_expand vs plain version on RMAT-{BFS_SCALE}")
    bfs_ec, bfs_graph, bfs_ea = make_bfs_graph()
    push = phase_scatter(scm, pe, bfs_graph, smi)

    print(f"  ({time.perf_counter() - t_start:.1f} s since the start)")
    print(f"[6/20] slice: BFS on RMAT-{BFS_SCALE}")
    bfs_root, bfs_launches, pull20, root_levels = phase_bfs(
        rg, pl, pe, scm, bfs_ec, bfs_graph, smi)

    print(f"  ({time.perf_counter() - t_start:.1f} s since the start)")
    print(f"[7/20] kernel: lane_shuffle vs plain version, "
          f"[{prr['graph'].advance_route.n // 128}, 128]")
    lsr = phase_lane_shuffle(ls, prr["graph"], smi)

    print(f"  ({time.perf_counter() - t_start:.1f} s since the start)")
    print(f"[8/20] slice: save and load RMAT-{SCALE}, then PageRank and BFS "
          f"on the loaded graph")
    kernels = _kernels()
    loaded = phase_persistence(kernels, prr, lsr["router_s"], smi)

    print(f"  ({time.perf_counter() - t_start:.1f} s since the start)")
    print(f"[9/20] kernel: pull_reduce with edge weights and scatter_combine "
          f"f32 vs plain versions on weighted RMAT-{BFS_SCALE}, and the "
          f"host's cost of one launch")
    wk = phase_weighted_kernels(rg, pl, scm, bfs_ec, bfs_graph, bfs_ea, smi)

    print(f"  ({time.perf_counter() - t_start:.1f} s since the start)")
    print(f"[10/20] slice: SSSP, SSWP, CC and HITS on weighted "
          f"RMAT-{BFS_SCALE}")
    fix = phase_fixpoint(kernels, bfs_ec, bfs_graph, bfs_ea, smi)
    prr["pull"]["max_err"] = max(prr["pull"]["max_err"], wk["pull_err"])

    print(f"  ({time.perf_counter() - t_start:.1f} s since the start)")
    print(f"[11/20] kernel: scatter_combine int32 add, its sorted build and "
          f"and_popcount vs plain versions, at the RMAT-{SCALE} triangle "
          f"count's shapes")
    k6 = phase_slice6_kernels(scm, ap, prr["ec"], smi)
    push["scatter"]["max_err"] = max(push["scatter"]["max_err"],
                                     wk["scatter"]["max_err"],
                                     k6["scatter_err"])

    print(f"  ({time.perf_counter() - t_start:.1f} s since the start)")
    print(f"[12/20] slice: SCC, coloring, label propagation, random walks, "
          f"reachability and triangle count on RMAT-{SCALE}")
    s6 = phase_slice6(kernels, prr["ec"], prr["graph"], k6["oriented"],
                      k6["host_s"], smi)

    print(f"  ({time.perf_counter() - t_start:.1f} s since the start)")
    print(f"[13/20] slice: GraphSAGE at ogbn-products' widths (in "
          f"{SAGE_IN}, hidden {SAGE_HIDDEN}, classes {SAGE_CLASSES}) on "
          f"RMAT-{BFS_SCALE}, sampled on RMAT-{SCALE}, and pull_rows vs plain "
          f"version")
    sage = phase_sage(kernels, prw, bfs_ec, bfs_graph, prr["graph"], smi)

    print(f"  ({time.perf_counter() - t_start:.1f} s since the start)")
    print(f"[14/20] slice: max-flow on RMAT-{SCALE}, and the general advance "
          f"and segment_reduce vs plain versions")
    mfr = phase_mf(kernels, pl, prr["ec"], smi)
    prr["pull"]["max_err"] = max(prr["pull"]["max_err"],
                                 mfr["pull"]["max_err"])

    print(f"  ({time.perf_counter() - t_start:.1f} s since the start)")
    print(f"[15/20] slice: the measurement runtime: the per-primitive pass "
          f"on RMAT-{SCALE} and weighted RMAT-{BFS_SCALE}, the PageRank app "
          f"with it, ubench_prims and the autotuner's samples")
    meas = phase_measurement(kernels, prr["graph"], bfs_graph, bfs_ea, smi)

    print(f"  ({time.perf_counter() - t_start:.1f} s since the start)")
    print(f"[16/20] slice: distribution on one card: the sharded container "
          f"and its one-card runners on weighted RMAT-{BFS_SCALE} in "
          f"{SHARDS} shards, the rank-parallel runners ({RANK_SHARDS} gloo "
          f"ranks sharing the card, one NCCL rank), sharded save and load "
          f"of RMAT-{SCALE}")
    keep_dir = tempfile.TemporaryDirectory()
    t16 = time.perf_counter()
    sh = phase_sharded(kernels, bfs_ec, bfs_graph, bfs_ea, bfs_root,
                       root_levels, fix["results"], prr["ec"], smi,
                       keep_dir.name)
    sh["numbers"]["phase_s"] = time.perf_counter() - t16
    print(f"  phase 16: {sh['numbers']['phase_s']:.1f} s")

    print(f"  ({time.perf_counter() - t_start:.1f} s since the start)")
    print(f"[17/20] slice: distribution part 2 on one card: MS-BFS, CC "
          f"hybrid, slim shards and SSSP on hashed weights over phase 16's "
          f"RMAT-{BFS_SCALE} shards, the five rank drivers and the sharded "
          f"GraphSAGE ({RANK_SHARDS} gloo ranks on RMAT-{GLOO_SCALE}, one "
          f"NCCL rank on RMAT-{BFS_SCALE}), streaming RMAT-{SCALE} from the "
          f"host")
    t17 = time.perf_counter()
    p2 = phase_part2(kernels, bfs_ec, bfs_graph, bfs_root, root_levels,
                     fix["results"], prr["ec"], sh, smi)
    del sh["kept"]
    keep_dir.cleanup()
    p2["numbers"]["phase_s"] = time.perf_counter() - t17
    print(f"  phase 17: {p2['numbers']['phase_s']:.1f} s")

    print(f"  ({time.perf_counter() - t_start:.1f} s since the start)")
    print(f"[18/20] slice: the large tier's path: apps/build_scale25.py "
          f"(rmat_fast, in a process of its own) at RMAT-{TIER_SCALE}/"
          f"{TIER_DEGREE} in {TIER_SHARDS} hash shards, loaded resident and "
          f"streamed: PageRank, stored-weight SSSP, MS-BFS and CC hybrid "
          f"in both, against each other and the host oracles")
    t18 = time.perf_counter()
    tier = phase_tier(kernels, smi)
    tier["numbers"]["phase_s"] = time.perf_counter() - t18
    print(f"  phase 18: {tier['numbers']['phase_s']:.1f} s")

    print(f"  ({time.perf_counter() - t_start:.1f} s since the start)")
    print(f"[19/20] slice: the scale-24 tier's path: apps/build_scale24.py "
          f"(in a process of its own) at RMAT-{S24_SCALE}/{S24_DEGREE} in "
          f"dst % S shards, apps/bench_scale24.py's rows resident against "
          f"the host oracles and the unsharded models, and "
          f"apps/crosscheck_scale20.py's check on the same graph")
    t19 = time.perf_counter()
    s24 = phase_scale24(kernels, bfs_ec, bfs_graph, smi)
    s24["numbers"]["phase_s"] = time.perf_counter() - t19
    print(f"  phase 19: {s24['numbers']['phase_s']:.1f} s")

    print(f"  ({time.perf_counter() - t_start:.1f} s since the start)")
    print(f"[20/20] slice: the LiveJournal-scale path at 1/16: "
          f"apps/make_lj_replica.py's graph at |V| {LJ_V:,}, |E| {LJ_E:,}, "
          f"apps/bench_lj.py's SSSP, CC and MS-BFS rows against the host "
          f"oracle (apps/exp_lj_oracle.py), and the path's kernels against "
          f"their plain versions at its shapes")
    t20 = time.perf_counter()
    lj = phase_lj(kernels, rg, pl, scm, smi)
    lj["numbers"]["phase_s"] = time.perf_counter() - t20
    print(f"  phase 20: {lj['numbers']['phase_s']:.1f} s")
    prr["route"]["max_err"] = max(prr["route"]["max_err"],
                                  lj["route"]["max_err"])
    prr["pull"]["max_err"] = max(prr["pull"]["max_err"], lj["pull"]["max_err"])
    push["scatter"]["max_err"] = max(push["scatter"]["max_err"],
                                     lj["scatter"]["max_err"])

    if "--profile" in sys.argv:
        profile(pl, prr["graph"], bfs_graph, bfs_root, bfs_ec, bfs_ea,
                prr["ec"], k6["oriented"], s6["core"],
                sys.argv[sys.argv.index("--profile") + 1])

    def times(r: dict) -> dict:
        return {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")}

    def paths(kernel: str) -> dict:
        by_path = {f"pagerank_rmat{SCALE}": prr["launches"].get(kernel, 0),
                   f"bfs_do_rmat{BFS_SCALE}": bfs_launches.get(kernel, 0),
                   f"loaded_rmat{SCALE}": loaded[kernel],
                   f"fixpoint_rmat{BFS_SCALE}": fix["launches"][kernel],
                   f"slice6_rmat{SCALE}": s6["launches"][kernel],
                   f"sage_rmat{BFS_SCALE}": sage["launches"][kernel],
                   f"mf_rmat{SCALE}": mfr["launches"][kernel],
                   **{p: c[kernel] for p, c in meas["launches"].items()},
                   **{p: c[kernel] for p, c in sh["launches"].items()},
                   **{p: c[kernel] for p, c in p2["launches"].items()},
                   **{p: c[kernel] for p, c in tier["launches"].items()},
                   **{p: c[kernel] for p, c in s24["launches"].items()},
                   **{p: c[kernel] for p, c in lj["launches"].items()}}
        if kernel == "scatter_combine":
            # scatter_combine.launches counts every entry of the source:
            # the general entries' row leaves out the sorted build's
            by_path = {k: c - s6["launches"]["scatter_combine_sorted"]
                       if k == f"slice6_rmat{SCALE}" else c
                       for k, c in by_path.items()}
            by_path["exp_push"] = push["scatter"]["launches"]
        return by_path

    def row(kernel: str, source: str, replaces: str, r: dict, **extra):
        by_path = paths(kernel)
        return {"name": kernel, "route": "cuda",
                "source": f"vectorgraphlibrary_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path, "max_abs_err": r["max_err"],
                **times(r), "bound_by": r.get("bound_by", "bytes"), **extra}
    route = prr["route"]
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": [
        row("route_gather_finish", "route_gather.cu", REPLACES, route,
            random_perm_2p24_ms=rand_ms,
            random_perm_2p24_plain_ms=rand_plain_ms,
            device_ms=route["device_ms"],
            library_device_ms=route["library_device_ms"],
            one_launch_128_slots=wk["launch"],
            rmat20_vertex_route=wk["route"], lj_1_16_vertex_route=times(
                lj["route"]),
            **{k: v for k, v in route.items() if k.startswith("advance_")}),
        row("pull_reduce", "pull_reduce.cu", REPLACES, prr["pull"],
            **{k: prr["pull"][k] for k in (
                "plan_build_ms", "tiles", "rows_cut",
                "device_kernels_per_call", "adversarial")},
            rmat20_i8_any01_ms=pull20["ms"],
            rmat20_i8_any01_plain_ms=pull20["plain_ms"],
            rmat20_i8_any01_bound_ms=pull20["bound_ms"],
            rmat20_max_abs_err=pull20["max_err"],
            rmat20_weighted={k: times(r) for k, r in wk["pulls"].items()},
            mf_level_rmat18_i32_min_of_max=times(mfr["pull"]),
            lj_1_16={k: times(lj["pull"][k])
                     for k in ("f32_min_of_x_plus_w", "i32_or")}),
        row("scatter_combine", "scatter_combine.cu", REPLACES_SCATTER,
            push["scatter"], device_ms=push["scatter"]["device_ms"],
            library_device_ms=push["scatter"]["library_device_ms"],
            f32_min={k: v for k, v in wk["scatter"].items()},
            int32_add=k6["add"], int32_retimed_and_in_place=wk["k4"],
            lj_1_16_f32_min=times(lj["scatter"])),
        row("scatter_combine_sorted", "scatter_combine.cu", REPLACES_SCATTER,
            k6["sorted"], **{k: v for k, v in k6["sorted"].items()
                             if k not in ("max_err", "ms", "plain_ms",
                                          "library_ms", "bound_ms",
                                          "bound_by")}),
        row("push_expand", "push_expand.cu", REPLACES_SCATTER, push["push"],
            device_ms=push["push"]["device_ms"]),
        row("lane_shuffle", "lane_shuffle.cu", REPLACES_LANE, lsr),
        row("and_popcount", "and_popcount.cu", REPLACES_POPCOUNT,
            k6["popcount"], **{k: v for k, v in k6["popcount"].items()
                               if k not in ("max_err", "ms", "plain_ms",
                                            "library_ms", "bound_ms",
                                            "bound_by")}),
        row("pull_rows", "pull_rows.cu", REPLACES_ROWS,
            dict(max_err=sage["max_err"],
                 **times(sage["times"][f"f{SAGE_HIDDEN}"])),
            shape=f"RMAT-{BFS_SCALE} GATHER CSR, F = {SAGE_HIDDEN}",
            floor_ms=sage["times"][f"f{SAGE_HIDDEN}"]["floor_ms"],
            by_shape=sage["times"], step_ms=sage["step_ms"],
            sampled_step_ms=sage["sampled_step_ms"],
            peak_mib=sage["peak_mib"]),
        row("segment_reduce", "pull_reduce.cu", REPLACES_SEGMENT, mfr,
            shape=f"i32 min over the RMAT-{SCALE} residual CSR",
            f32_add_ms=mfr["f32_add_ms"],
            f32_add_library_ms=mfr["f32_add_library_ms"])],
        "rates": dict(s6["rates"], mf_mteps=mfr["rates"]),
        "prim_tables": meas["tables"],
        "autotuner_picks": meas["autotuner_picks"],
        "sharded": sh["numbers"], "part2": p2["numbers"],
        "tier": tier["numbers"], "scale24": s24["numbers"],
        "lj": lj["numbers"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
