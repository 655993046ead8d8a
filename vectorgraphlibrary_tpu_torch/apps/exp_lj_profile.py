"""Where bench_lj's rows spend their time on the card (CUDA only).

    python -m vectorgraphlibrary_tpu_torch.apps.exp_lj_profile [-top 8]

Imports lj-replica as apps/bench_lj.py does, warms each row up with its
warm-up call, then runs its timed call once under
runtime/profiling.profile_call: the wall seconds, the device's busy
seconds and share, and the `-top` operators by their own device time.
One JSON line per row, after the card's name and power limit; exits 1,
with a JSON note, when the graph file is missing.
"""
from __future__ import annotations

import argparse
import json
import sys

from . import bench_lj
from .make_lj_replica import NAME
from .scale_tier import smi


def main(argv=None) -> int:
    from ..io import corpus
    from ..models import bfs, cc, sssp
    from ..runtime.profiling import profile_call
    p = argparse.ArgumentParser(prog="exp_lj_profile")
    p.add_argument("-top", type=int, default=8)
    args = p.parse_args(argv)
    ec = corpus.load(NAME, fetch=False)
    if ec is None:
        print(json.dumps({"note": f"no {NAME} under {corpus.graph_dir()}"}))
        return 1
    print(smi(), flush=True)
    wec, g, ea, _ = bench_lj.load(ec, "cuda")
    deg = bench_lj.out_degrees(wec)
    (ws, ts), (wr, tr) = bench_lj.sources(deg), bench_lj.roots(deg)
    wh, th = bench_lj.hubs(g.v)
    rows = {"sssp": (lambda: sssp.vgl_dijkstra_multi(g, ea, ws),
                     lambda: sssp.vgl_dijkstra_multi(g, ea, ts)),
            "cc": (lambda: cc.vgl_cc_hybrid_multi(g, wh),
                   lambda: cc.vgl_cc_hybrid_multi(g, th)),
            "msbfs": (lambda: bfs.vgl_msbfs(g, wr),
                      lambda: bfs.vgl_msbfs(g, tr))}
    for name, (warm, timed) in rows.items():
        warm()
        print(json.dumps(dict(row=name, graph=NAME,
                              **profile_call(timed, args.top))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
