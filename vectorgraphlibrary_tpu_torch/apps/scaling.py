"""Strong/weak scaling over rank counts (port of apps/scaling.py).

    python -m vectorgraphlibrary_tpu_torch.apps.scaling [--devices 1,2,4,8]
        [-s 14] [-e 16] [--weak] [--iters 20] [--cpu]

Capability match for the reference's scalability scripts
(`apps/bin/strong_scalability.sh:1-18`, `weak_scalability.sh`: mpirun -np
1..N sweeps). For each n of the sweep, n ranks (parallel/launch.py) each
build their own destination shard of RMAT-s (average degree e, seed 42)
and run PageRank through the rank-parallel runner (parallel/sharded.
make_pr_sharded), timed with runtime/timer.DeviceTimer after one warm-up
run; the slowest rank's time counts. --weak grows the scale with log2(n).

With --cpu the ranks are gloo processes on the CPU; without it they share
the one card, as gloo ranks on CUDA tensors (all_reduce only). Either way
the ranks share their hardware, so efficiency is read as the reference
reads its virtual mesh (apps/scaling.py:70-79): ideal strong scaling keeps
the wall time constant (eff = t_1 / t_n), ideal weak scaling grows it n-fold
(eff = n * t_1 / t_n). The last line is one JSON object.
"""
from __future__ import annotations

import argparse
import json
import sys


def scaling_rank(rank: int, world: int, device, scale: int, degree: int,
                 iters: int) -> dict:
    """One rank's seconds for one make_pr_sharded run (launch.run_ranks)."""
    from ..io import generation
    from ..parallel import sharded
    from ..parallel.mesh import make_mesh
    from ..parallel.shard_build import import_shard
    from ..runtime.timer import DeviceTimer, block
    ec = generation.rmat(scale=scale, avg_degree=degree, seed=42)
    g = import_shard(ec, world, rank, device=device)
    run = sharded.make_pr_sharded(g, make_mesh(world, 1, device), ec,
                                  max_iterations=iters)
    block(run())                                   # warm-up
    timer = DeviceTimer(device).start()
    ranks = run()
    return dict(seconds=timer.stop(ranks), edges=ec.edges_count)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="scaling")
    p.add_argument("--devices", default="1,2,4,8")
    p.add_argument("-s", type=int, default=14)
    p.add_argument("-e", type=int, default=16)
    p.add_argument("--weak", action="store_true",
                   help="weak scaling: scale grows with the rank count")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--cpu", action="store_true",
                   help="gloo ranks on the CPU (default: ranks on the card)")
    args = p.parse_args(argv)
    from ..parallel.launch import run_ranks
    if args.cpu:
        device, backend, kind = "cpu", None, "cpu"
    else:
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("scaling: no CUDA device (use --cpu)")
        device, backend = "cuda", "gloo"
        kind = torch.cuda.get_device_name(0)
    results = []
    base_dt = None
    for n in [int(x) for x in args.devices.split(",")]:
        scale = args.s + (n.bit_length() - 1 if args.weak else 0)
        ranks = run_ranks("vectorgraphlibrary_tpu_torch.apps.scaling:"
                          "scaling_rank", n, device=device, backend=backend,
                          kwargs=dict(scale=scale, degree=args.e,
                                      iters=args.iters), timeout=3600)
        dt = max(float(r["seconds"]) for r in ranks) / args.iters
        edges = int(ranks[0]["edges"])
        if base_dt is None:
            base_dt = dt
        eff = (n * base_dt) / dt if args.weak else base_dt / dt
        results.append(dict(devices=n, scale=scale, edges=edges,
                            edges_per_device=edges // n, s_per_iter=dt,
                            mteps=edges / dt / 1e6, efficiency=eff))
        print(results[-1])
    print(json.dumps({"mode": "weak" if args.weak else "strong",
                      "virtual_mesh": True, "device": kind,
                      "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
