"""The large tier streamed (the port's counterpart of apps/bench_scale25.py):
the artifact of apps/build_scale25.py (RMAT-25 at degree 32 by default)
held in host memory, pinned, and copied to the card one shard at a time per
sweep (parallel/streaming.py).

    python -m vectorgraphlibrary_tpu_torch.apps.bench_scale25 [-dev cuda]

The same environment as the builder names the artifact (VGL_S25_SCALE,
VGL_S25_DEGREE, VGL_S25_CACHE). The rows, each one call timed by
runtime/timer.DeviceTimer after one PageRank iteration to warm up:

- PageRank: 3 iterations, MTEPS = |E| * 3 / t;
- HITS: 2 iterations of two sweeps each, MTEPS = |E| * 2 * 2 / t;
- MS-BFS from 32 roots (drawn from seed 25), GTEPS = the roots' traversed
  edges (the out-degrees of the vertices each reaches) / t;
- SSSP on the stored weights, all-active Bellman-Ford to its fixpoint
  from the hub, MTEPS = |E| / t;
- CC, the flood hybrid from the hub, MTEPS = |E| / t.

The hub is the vertex of the largest out-degree without self-loops (the
builder's .prconsts.npz). Each row holds its sweeps, their seconds (median,
min, max), the bytes copied over the call per second, and the shards ever
resident at once; a first line gives one sweep of the copies alone (the
host-to-device rate), the pinned bytes and the load's seconds. One JSON
line per row on stdout; nothing is written to a file. Exits 1, with a JSON
note, when the artifact is missing. -dev cpu runs the same on the CPU (no
pinning; the CPU tests' size).
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time

import numpy as np
import torch

from .scale_tier import (device_label, emit, load_consts, log, no_artifact,
                         settings, tensor_bytes, timed_call, traversed_edges)

ROOTS_SEED = 25
PR_ITERS, HITS_ITERS = 3, 2


def _timed(ssg, device, fn):
    """(result, seconds, sweep seconds, bytes copied, peak device bytes)
    of fn()."""
    n, h2d = len(ssg.sweep_s), ssg.h2d_bytes
    out, seconds, peak = timed_call(device, fn)
    return out, seconds, ssg.sweep_s[n:], ssg.h2d_bytes - h2d, peak


def run(prefix: str, device="cuda") -> list:
    """Load `prefix` streamed to `device` and emit the rows (module doc);
    -> the rows."""
    from ..parallel import streaming
    device = torch.device(device)
    t0 = time.perf_counter()
    ssg = streaming.load_streamed(prefix, weights=True, device=device)
    load_s = time.perf_counter() - t0
    consts = load_consts(prefix, ssg.v_pad, device)
    e, v = ssg.e, ssg.v
    scale = v.bit_length() - 1
    base = {"scale": scale, "device": device_label(device),
            "protocol": "host-streaming: slim shards pinned in host memory, "
            "one copied to the card per step of each sweep"}
    log(f"loaded {ssg.n_shards} shards |V|={v:,} |E|={e:,} ({load_s:.1f} s)")
    t0 = time.perf_counter()
    streaming._sweep(ssg, lambda g, s: None, "copy")
    copy_s = time.perf_counter() - t0
    rows = [emit(dict(
        metric="streamed_copy", value=ssg.h2d_bytes / copy_s / 1e9,
        unit="GB/s", load_s=load_s, sweep_s=copy_s,
        pinned_bytes=sum(tensor_bytes(g) for g in ssg.shards)
        + sum(tensor_bytes(w) for w in ssg.weights), **base))]

    def row(metric, value, unit, sweeps, copied, seconds, peak, **extra):
        rows.append(emit(dict(
            metric=metric, value=value, unit=unit, seconds=seconds,
            sweeps=len(sweeps), sweep_s_median=statistics.median(sweeps),
            sweep_s_min=min(sweeps), sweep_s_max=max(sweeps),
            h2d_gb_s=copied / seconds / 1e9,
            peak_resident=ssg.peak_resident, peak_device_bytes=peak,
            **extra, **base)))

    # the warm-up: the kernels' build and first launches
    streaming.pagerank_streamed(ssg, consts.rev, consts.dmask, iterations=1,
                                progress=log)
    ranks, dt, sw, cp, pk = _timed(ssg, device, lambda: streaming.pagerank_streamed(
        ssg, consts.rev, consts.dmask, iterations=PR_ITERS, progress=log))
    row(f"pagerank_rmat{scale}_mteps", e * PR_ITERS / dt / 1e6, "MTEPS", sw,
        cp, dt, pk, iters=PR_ITERS, ranks_sum=float(ranks.double().sum()))
    _, dt, sw, cp, pk = _timed(ssg, device, lambda: streaming.hits_streamed(
        ssg, iterations=HITS_ITERS, progress=log))
    row(f"hits_rmat{scale}_mteps", e * HITS_ITERS * 2 / dt / 1e6, "MTEPS",
        sw, cp, dt, pk, iters=HITS_ITERS)
    roots = np.random.default_rng(ROOTS_SEED).integers(0, v, 32).astype(
        np.int32)
    (levels, n_lev), dt, sw, cp, pk = _timed(
        ssg, device, lambda: streaming.msbfs_streamed(ssg, roots,
                                                      progress=log))
    edges = traversed_edges(levels, consts.outdeg)
    row(f"bfs_msbfs_rmat{scale}_gteps", edges / dt / 1e9, "GTEPS", sw, cp,
        dt, pk, roots=32, levels=int(n_lev), edges_traversed=edges)
    (dist, iters), dt, sw, cp, pk = _timed(
        ssg, device, lambda: streaming.sssp_streamed(ssg, consts.hub,
                                                     progress=log))
    row(f"sssp_rmat{scale}_mteps", e / dt / 1e6, "MTEPS", sw, cp, dt, pk,
        iters=int(iters), source=consts.hub,
        reached=int(torch.isfinite(dist[:v]).sum()),
        weights="stored per-edge f32 in route-slot order, from disk")
    (labels, fl, hi), dt, sw, cp, pk = _timed(
        ssg, device, lambda: streaming.cc_hybrid_streamed(ssg, consts.hub,
                                                          progress=log))
    row(f"cc_rmat{scale}_mteps", e / dt / 1e6, "MTEPS", sw, cp, dt, pk,
        components=int(torch.unique(labels[:v]).numel()),
        flood_levels=int(fl), hook_iters=int(hi))
    return rows


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="bench_scale25")
    p.add_argument("-dev", default="cuda",
                   help="where the sweeps run (cuda; cpu for the tests)")
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    prefix = settings(25)["prefix"]
    if no_artifact(prefix, "bench_scale25"):
        return 1
    run(prefix, args.dev)
    log("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
