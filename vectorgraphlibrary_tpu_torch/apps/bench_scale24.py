"""The scale-24 tier on the card (the port's counterpart of
apps/bench_scale24.py): the artifact of apps/build_scale24.py (RMAT-24 at
degree 16 in dst % S slim shards) loaded resident
(persistence.load_sharded_graph), and the one-card scans over its shards in
turn (parallel/sharded.*_scan).

    python -m vectorgraphlibrary_tpu_torch.apps.bench_scale24 [-dev cuda] [pagerank hits bfs msbfs sssp cc]

The same environment as the builder names the artifact (VGL_S24_SCALE,
VGL_S24_DEGREE, VGL_S24_CACHE). The rows (a subset where named), under
the JAX script's metric names and by its formulas:

- pagerank_rmat{S}_mteps: 10 iterations, |E| * 10 / t, the degree
  constants put on the device before the timed window, as the JAX script
  does; the ranks' sum;
- hits_rmat{S}_mteps: 5 iterations, |E| * 5 * 2 / t;
- bfs_rmat{S}_gteps: level-synchronous pull BFS from vertex 2 (warmed up
  from vertex 1), |E| / t; the vertices reached;
- bfs_msbfs_rmat{S}_gteps: 32 roots from np.random.default_rng(24), the
  roots' traversed edges (scale_tier.traversed_edges, counted outside the
  timed window) / t;
- sssp_partial_rmat{S}_mteps and sssp_partial_rmat{S}_periter_mteps:
  partial-active SSSP on the slot-hash weights from vertex 2 (warmed up
  from vertex 1), |E| / t and |E| * sweeps / t; reached and sweeps;
- cc_sv_rmat{S}_mteps and cc_periter_rmat{S}_mteps: the flood hybrid from
  the hub (the largest out-degree), |E| / t and |E| * 2 * (flood levels +
  hook iterations) / t; the component count (torch.unique, outside the
  timed window).

Each row is timed by runtime/timer.DeviceTimer over 3 calls after a
warm-up call: t is their median, and the row keeps their seconds, min and
max, the card's peak allocated bytes over them, and the whole-graph pulls
of one timed call and of the warm-up (each pull is one pull_reduce and two
route_gather launches per shard, three with partial SSSP's source mask).
A first line gives the load's seconds and the bytes of the shards on the
device. One JSON line per row on stdout; nothing is written to a file (the
JAX script writes BENCH_SCALE24.json; this app leaves it alone). Exits 1,
with a JSON note, when the artifact is missing. -dev cpu runs the same on
the CPU (the tests' size).
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time

import numpy as np
import torch

from .scale_tier import (device_label, emit, load_consts, log, no_artifact,
                         settings24, tensor_bytes, timed_call,
                         traversed_edges)

ROWS = ("pagerank", "hits", "bfs", "msbfs", "sssp", "cc")
PR_ITERS, HITS_ITERS = 10, 5
SOURCE, WARM_SOURCE = 2, 1
ROOTS_SEED, N_ROOTS = 24, 32
REPS = 3


def roots_of(v: int) -> np.ndarray:
    """The JAX script's 32 MS-BFS roots."""
    return np.random.default_rng(ROOTS_SEED).integers(0, v, N_ROOTS).astype(
        np.int32)


def load(prefix: str, device):
    """The artifact resident on `device`: (the sharded graph, its
    scale_tier.Consts, the load's row)."""
    from ..graph import persistence
    device = torch.device(device)
    t0 = time.perf_counter()
    sg = persistence.load_sharded_graph(prefix, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    load_s = time.perf_counter() - t0
    consts = load_consts(prefix, sg.v_pad, device)
    log(f"loaded {sg.n_shards} shards |V|={sg.v:,} |E|={sg.e:,} "
        f"({load_s:.1f} s)")
    return sg, consts, emit(dict(
        metric="resident_load", value=load_s, unit="s",
        graph_bytes=sum(tensor_bytes(g) for g in sg.shards),
        n_shards=sg.n_shards, edges_per_shard=list(sg.edges_per_shard),
        **_base(sg, device)))


def _base(sg, device: torch.device) -> dict:
    return {"scale": sg.v.bit_length() - 1,
            "avg_degree": sg.e // max(sg.v, 1), "device": device_label(device)}


def measure(sg, consts, device, only=ROWS, results=None) -> list:
    """Emit the rows of `only` (module doc) on the loaded graph; -> the
    rows. results: a dict that receives each row's output of its last
    timed call, by row name."""
    from ..parallel import sharded
    device = torch.device(device)
    e, v, hub = sg.e, sg.v, consts.hub
    s = f"rmat{sg.v.bit_length() - 1}"
    base = _base(sg, device)
    results = {} if results is None else results
    rows = []

    def timed(name, warm, fn, steps):
        """warm(), then fn() REPS times; -> (the last output, the median
        seconds, the fields every row of it keeps)."""
        w = warm()
        times, peaks = [], []
        for _ in range(REPS):
            out, seconds, peak = timed_call(device, fn)
            times.append(seconds)
            peaks.append(peak)
        results[name] = out
        t = statistics.median(times)
        return out, t, dict(
            seconds=t, seconds_min=min(times), seconds_max=max(times),
            peak_device_bytes=None if peaks[0] is None else max(peaks),
            pull_steps=steps(out), warmup_pull_steps=steps(w))

    def row(metric, value, unit, fields, **extra):
        rows.append(emit(dict(metric=metric, value=value, unit=unit,
                              **fields, **extra, **base)))

    if "pagerank" in only:
        rev, dmask = sharded.pr_consts_on(sg, consts.rev, consts.dmask)

        def pagerank():
            return sharded.pagerank_sharded_scan_consts(sg, rev, dmask,
                                                        PR_ITERS)
        ranks, t, f = timed("pagerank", pagerank, pagerank,
                            lambda _: PR_ITERS)
        row(f"pagerank_{s}_mteps", e * PR_ITERS / t / 1e6, "MTEPS", f,
            iters=PR_ITERS, ranks_sum=float(ranks.double().sum()))
    if "hits" in only:
        def hits():
            return sharded.hits_sharded_scan(sg, HITS_ITERS)
        _, t, f = timed("hits", hits, hits, lambda _: 2 * HITS_ITERS)
        row(f"hits_{s}_mteps", e * HITS_ITERS * 2 / t / 1e6, "MTEPS", f,
            iters=HITS_ITERS)
    if "bfs" in only:
        levels, t, f = timed(
            "bfs", lambda: sharded.bfs_sharded_scan(sg, WARM_SOURCE),
            lambda: sharded.bfs_sharded_scan(sg, SOURCE),
            lambda lv: int(lv.max()))
        row(f"bfs_{s}_gteps", e / t / 1e9, "GTEPS", f, source=SOURCE,
            reached=int((levels[:v] > 0).sum()))
    if "msbfs" in only:
        roots = roots_of(v)
        levels, t, f = timed(
            "msbfs", lambda: sharded.msbfs_sharded_scan(sg, roots),
            lambda: sharded.msbfs_sharded_scan(sg, roots),
            lambda lv: int(lv.max()))
        edges = traversed_edges(levels, consts.outdeg)
        row(f"bfs_msbfs_{s}_gteps", edges / t / 1e9, "GTEPS", f,
            roots=N_ROOTS, edges_traversed=edges,
            protocol="bit-parallel multi-source (MS-BFS), one or-pull scan "
            "per level serves all 32 roots")
    if "sssp" in only:
        (dist, sweeps), t, f = timed(
            "sssp", lambda: sharded.sssp_sharded_scan_hash(sg, WARM_SOURCE),
            lambda: sharded.sssp_sharded_scan_hash(sg, SOURCE),
            lambda out: int(out[1]))
        reached = int(torch.isfinite(dist[:v]).sum())
        row(f"sssp_partial_{s}_mteps", e / t / 1e6, "MTEPS", f,
            iters=sweeps, reached=reached, source=SOURCE,
            weights="deterministic per-slot hash U[0.01,1) "
            "(parallel/sharded.slot_hash_weight_fn)")
        row(f"sssp_partial_{s}_periter_mteps", e * sweeps / t / 1e6, "MTEPS",
            f, iters=sweeps)
    if "cc" in only:
        def cc():
            return sharded.cc_hybrid_sharded_scan(sg, hub)
        (labels, fl, hi), t, f = timed("cc", cc, cc,
                                       lambda out: 2 * (out[1] + out[2]))
        sweeps = 2 * (fl + hi)
        row(f"cc_sv_{s}_mteps", e / t / 1e6, "MTEPS", f,
            components=int(torch.unique(labels[:v]).numel()),
            flood_levels=int(fl), hook_iters=int(hi), hub=hub,
            protocol="flood-hybrid: bool or-pull flood of the hub component "
            "+ hook-min for the tail")
        row(f"cc_periter_{s}_mteps", e * sweeps / t / 1e6, "MTEPS", f,
            sweeps=sweeps)
    return rows


def run(prefix: str, device="cuda", only=ROWS, results=None) -> list:
    """Load `prefix` onto `device` and emit the rows of `only`; -> the load's
    row and the rows."""
    sg, consts, load_row = load(prefix, device)
    return [load_row] + measure(sg, consts, device, only, results)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="bench_scale24")
    p.add_argument("rows", nargs="*", choices=ROWS,
                   help="the rows to run (all by default)")
    p.add_argument("-dev", default="cuda",
                   help="where the scans run (cuda; cpu for the tests)")
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    prefix = settings24()["prefix"]
    if no_artifact(prefix, "bench_scale24", "build_scale24"):
        return 1
    run(prefix, args.dev, tuple(args.rows) or ROWS)
    log("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
