"""Host oracle for the scale-24 tier's graph properties, independent of the
port's device code: the graph that apps/build_scale24.py builds
(io/generation.rmat(S, D, seed=42), unweighted) generated again and
searched by scipy.

    python -m vectorgraphlibrary_tpu_torch.apps.exp_scale24_oracle

The same environment as the builder (VGL_S24_SCALE, VGL_S24_DEGREE). One
JSON line: the vertices reached from apps/bench_scale24.SOURCE (BFS, and
partial SSSP on any positive weights), the MS-BFS traversed edges of
bench_scale24's 32 roots (each root's reached vertices' out-degrees
without self-loops, summed in int64), and the weak components; and the
seconds of each step. Host only: it creates no CUDA context.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np


def oracle(ec) -> dict:
    """The properties (module doc) of the graph `ec`."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import breadth_first_order, connected_components
    from .bench_scale24 import SOURCE, roots_of
    v, t0 = ec.vertices_count, time.time()
    a = sp.csr_matrix((np.ones(ec.edges_count, bool),
                       (ec.src_ids, ec.dst_ids)), shape=(v, v))
    nonloop = ec.src_ids != ec.dst_ids
    deg = np.bincount(ec.src_ids[nonloop], minlength=v).astype(np.int64)
    out = {"v": v, "e": ec.edges_count, "matrix_s": time.time() - t0}
    t0 = time.time()

    def reached(root: int) -> np.ndarray:
        return breadth_first_order(a, root, directed=True,
                                   return_predecessors=False)

    out["reached_from_source"] = int(len(reached(SOURCE)))
    out["source"] = SOURCE
    out["msbfs_edges_traversed"] = int(sum(
        int(deg[reached(int(r))].sum()) for r in roots_of(v)))
    out["bfs_s"] = time.time() - t0
    t0 = time.time()
    out["components"] = int(connected_components(
        a, directed=True, connection="weak")[0])
    out["components_s"] = time.time() - t0
    return out


def main() -> int:
    from ..io import generation
    from .scale_tier import log, settings24
    cfg = settings24()
    t0 = time.time()
    ec = generation.rmat(cfg["scale"], cfg["degree"], seed=42,
                         weighted=False)
    gen_s = time.time() - t0
    log(f"generated |V|={ec.vertices_count:,} |E|={ec.edges_count:,} "
        f"({gen_s:.1f} s)")
    print(json.dumps(dict(oracle(ec), scale=cfg["scale"],
                          degree=cfg["degree"], gen_s=gen_s)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
