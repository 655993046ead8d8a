"""The scale-24 tier's spot check at a quarter of its scale (the port's
counterpart of apps/crosscheck_scale20.py): PageRank over the sharded scan
path that apps/bench_scale24.py runs (parallel/shard_build.import_sharded
in 2 slim dst % S shards, then parallel/sharded.pagerank_sharded_scan)
against the unsharded models/pr.vgl_page_rank over graph/device.
import_graph and the host oracle seq_page_rank, all on one RMAT COO (seed
42, unweighted).

    python -m vectorgraphlibrary_tpu_torch.apps.crosscheck_scale20 [-s 20] [-e 16] [-it 10] [-dev cuda]

Prints the three max-abs errors and ok (the scan's and the unsharded
run's errors against the oracle both under 1e-6) as one JSON line, and
exits 1 where not ok. Writes no file (the JAX script writes
SCALE20_CROSSCHECK.json; this app leaves it alone).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

TOL = 1e-6
SHARDS = 2


def crosscheck(ec, iters: int, device="cuda", graph=None) -> dict:
    """The three runs on `ec` (module doc); graph: import_graph(ec) on
    `device` where the caller holds it already. -> the JSON line's fields."""
    from ..graph.device import import_graph
    from ..graph.vertices import as_original_numpy
    from ..models import pr
    from ..parallel import sharded
    from ..parallel.shard_build import import_sharded
    device = torch.device(device)
    v = ec.vertices_count
    t0 = time.time()
    sg = import_sharded(ec, SHARDS, device=device, slim=True)
    got_scan = sharded.pagerank_sharded_scan(
        sg, ec, max_iterations=iters)[:v].cpu().numpy()
    del sg
    print(f"[{time.time() - t0:.0f}s] scan PR done", flush=True)
    if graph is None:
        graph = import_graph(ec, device=device)
    ranks, _ = pr.vgl_page_rank(graph, max_iterations=iters,
                                use_convergence=False)
    got_single = as_original_numpy(ranks, graph)[:v]
    print(f"[{time.time() - t0:.0f}s] unsharded PR done", flush=True)
    want = pr.seq_page_rank(ec, max_iterations=iters, use_convergence=False)
    err_scan = float(np.max(np.abs(got_scan - want)))
    err_single = float(np.max(np.abs(got_single - want)))
    return {"scale": v.bit_length() - 1,
            "avg_degree": ec.edges_count // max(v, 1), "iters": iters,
            "shards": SHARDS,
            "max_abs_err_scan_vs_oracle": err_scan,
            "max_abs_err_single_vs_oracle": err_single,
            "max_abs_err_scan_vs_single": float(np.max(np.abs(
                got_scan - got_single))),
            "ok": err_scan < TOL and err_single < TOL,
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu")}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="crosscheck_scale20")
    p.add_argument("-s", type=int, default=20, help="RMAT scale")
    p.add_argument("-e", type=int, default=16, help="average degree")
    p.add_argument("-it", type=int, default=10, help="PageRank iterations")
    p.add_argument("-dev", default="cuda",
                   help="where the runs go (cuda; cpu for the tests)")
    return p


def main(argv=None) -> int:
    from ..io import generation
    args = parser().parse_args(argv)
    ec = generation.rmat(args.s, args.e, seed=42, weighted=False)
    out = crosscheck(ec, args.it, args.dev)
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
