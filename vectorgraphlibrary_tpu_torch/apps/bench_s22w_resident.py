"""The large tier resident on the card (the port's counterpart of
apps/bench_s22w_resident.py): the artifact of apps/build_scale25.py loaded
whole (persistence.load_sharded_graph) with its stored weights
(parallel/sharded.slot_weights_stacked), and the one-card scans over its
shards in turn. RMAT-22 at degree 32 (the reference's `syn_rmat_22_32`) by
default; any VGL_S25_SCALE whose shards the card holds (RMAT-25 at degree
32 in 8 slim shards takes about 21 GiB).

    VGL_S25_SCALE=22 python -m vectorgraphlibrary_tpu_torch.apps.bench_s22w_resident [-dev cuda] [sssp msbfs cc pagerank]

The rows (a subset where named), each one call timed by
runtime/timer.DeviceTimer after a warm-up call:

- SSSP on the stored weights, partial-active to its fixpoint from the hub
  (warmed up from the next vertex), MTEPS = |E| / t, and per sweep
  |E| * sweeps / t;
- MS-BFS from 32 roots (drawn from seed 22), GTEPS = the roots' traversed
  edges / t;
- CC, the flood hybrid from the hub, MTEPS = |E| / t;
- PageRank, 10 iterations, MTEPS = |E| * 10 / t, the degree constants
  put on the device before the warm-up (parallel/sharded.pr_consts_on), so
  that no timed call copies them.

The hub is the vertex of the largest out-degree without self-loops (the
builder's .prconsts.npz). A first line gives the load's seconds and the
bytes of the shards and weights on the device; each row its peak device
memory. One JSON line per row on stdout; nothing is written to a file.
Exits 1, with a JSON note, when the artifact is missing.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .scale_tier import (device_label, emit, load_consts, log, no_artifact,
                         settings, tensor_bytes, timed_call, traversed_edges)

ROOTS_SEED = 22
PR_ITERS = 10
ROWS = ("sssp", "msbfs", "cc", "pagerank")


def run(prefix: str, device="cuda", only=ROWS) -> list:
    """Load `prefix` onto `device` and emit the rows of `only` (module
    doc); -> the rows."""
    from ..graph import persistence
    from ..parallel import sharded
    device = torch.device(device)
    t0 = time.perf_counter()
    sg = persistence.load_sharded_graph(prefix, device=device)
    weights = sharded.slot_weights_stacked(persistence.load_sharded_weights(
        prefix, sg.n_shards, device), sg)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    load_s = time.perf_counter() - t0
    consts = load_consts(prefix, sg.v_pad, device)
    e, v, hub = sg.e, sg.v, consts.hub
    scale = v.bit_length() - 1
    base = {"scale": scale, "device": device_label(device),
            "protocol": "resident: every shard and its weights on the card, "
            "the scans over the shards in turn"}
    log(f"loaded {sg.n_shards} shards |V|={v:,} |E|={e:,} ({load_s:.1f} s)")
    rows = [emit(dict(metric="resident_load", value=load_s, unit="s",
                      graph_bytes=sum(tensor_bytes(g) for g in sg.shards),
                      weight_bytes=tensor_bytes(weights), **base))]

    def timed(warm, fn):
        warm()
        return timed_call(device, fn)

    def row(metric, value, unit, seconds, peak, **extra):
        rows.append(emit(dict(metric=metric, value=value, unit=unit,
                              seconds=seconds, peak_device_bytes=peak,
                              **extra, **base)))

    if "sssp" in only:
        (dist, iters), dt, pk = timed(
            lambda: sharded.sssp_sharded_scan(sg, weights, (hub + 1) % v),
            lambda: sharded.sssp_sharded_scan(sg, weights, hub))
        row(f"sssp_rmat{scale}_mteps", e / dt / 1e6, "MTEPS", dt, pk,
            iters=int(iters), source=hub, periter_mteps=e * iters / dt / 1e6,
            reached=int(torch.isfinite(dist[:v]).sum()),
            weights="stored per-edge f32 in route-slot order, from disk")
    if "msbfs" in only:
        roots = np.random.default_rng(ROOTS_SEED).integers(0, v, 32).astype(
            np.int32)
        levels, dt, pk = timed(lambda: sharded.msbfs_sharded_scan(sg, roots),
                               lambda: sharded.msbfs_sharded_scan(sg, roots))
        edges = traversed_edges(levels, consts.outdeg)
        row(f"bfs_msbfs_rmat{scale}_gteps", edges / dt / 1e9, "GTEPS", dt, pk,
            roots=32, edges_traversed=edges)
    if "cc" in only:
        (labels, fl, hi), dt, pk = timed(
            lambda: sharded.cc_hybrid_sharded_scan(sg, hub),
            lambda: sharded.cc_hybrid_sharded_scan(sg, hub))
        row(f"cc_rmat{scale}_mteps", e / dt / 1e6, "MTEPS", dt, pk,
            components=int(torch.unique(labels[:v]).numel()),
            flood_levels=int(fl), hook_iters=int(hi))
    if "pagerank" in only:
        rev, dmask = sharded.pr_consts_on(sg, consts.rev, consts.dmask)
        ranks, dt, pk = timed(
            lambda: sharded.pagerank_sharded_scan_consts(sg, rev, dmask, 1),
            lambda: sharded.pagerank_sharded_scan_consts(sg, rev, dmask,
                                                         PR_ITERS))
        row(f"pagerank_rmat{scale}_mteps", e * PR_ITERS / dt / 1e6, "MTEPS",
            dt, pk, iters=PR_ITERS, ranks_sum=float(ranks.double().sum()))
    return rows


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="bench_s22w_resident")
    p.add_argument("rows", nargs="*", choices=ROWS,
                   help="the rows to run (all by default)")
    p.add_argument("-dev", default="cuda",
                   help="where the scans run (cuda; cpu for the tests)")
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    prefix = settings(22)["prefix"]
    if no_artifact(prefix, "bench_s22w_resident"):
        return 1
    run(prefix, args.dev, tuple(args.rows) or ROWS)
    log("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
