"""Host oracle for apps/bench_lj.py's rows, independent of the port's
device code: the same graph and seeds searched by scipy.

    python -m vectorgraphlibrary_tpu_torch.apps.exp_lj_oracle

Reads {io.corpus.graph_dir()}/lj-replica.el_container (weights in [1,
100) from seed 7 where it has none, as bench_lj gives them) and prints
one JSON line: the weak component count; for each of bench_lj's 64 timed
MS-BFS roots its reached vertices and traversed edges (the reached
vertices' out-degrees, every edge counted, summed in int64); for each of
its 8 timed SSSP sources the reached vertices and the sum of the finite
distances (scipy's dijkstra over the least weight of repeated edges,
models/sssp.seq_dijkstra); and each step's seconds. `oracle()` also
gives each vertex's weak component, which bench_lj holds its CC runs to.
Exits 1, with a JSON note, when the graph file is missing. Host only: it
creates no CUDA context.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np


def oracle(ec, sssp_sources, bfs_roots) -> dict:
    """The properties (module doc) of the weighted graph `ec`: components
    (int), labels (int32 [v], each vertex's weak component), reached (bool [roots, v]), traversed (int64 [roots]), dist
    (f32 [sources, v], +inf unreached), seconds (the steps'), and each
    step's seconds by name."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import breadth_first_order, connected_components
    from ..models.sssp import seq_dijkstra
    v, t0 = ec.vertices_count, time.perf_counter()
    a = sp.csr_matrix((np.ones(ec.edges_count, bool),
                       (ec.src_ids, ec.dst_ids)), shape=(v, v))
    deg = np.bincount(ec.src_ids, minlength=v).astype(np.int64)
    out = {"matrix_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    n, labels = connected_components(a, directed=True, connection="weak")
    out.update(components=int(n), labels=labels)
    out["components_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    reached = np.zeros((len(bfs_roots), v), bool)
    traversed = np.zeros(len(bfs_roots), np.int64)
    for i, r in enumerate(bfs_roots):
        ids = breadth_first_order(a, int(r), directed=True,
                                  return_predecessors=False)
        reached[i, ids] = True
        traversed[i] = deg[ids].sum()
    out.update(reached=reached, traversed=traversed,
               bfs_s=time.perf_counter() - t0)
    del a
    t0 = time.perf_counter()
    out["dist"] = (seq_dijkstra(ec, list(sssp_sources)) if len(sssp_sources)
                   else np.zeros((0, v), np.float32))
    out["sssp_s"] = time.perf_counter() - t0
    out["seconds"] = sum(out[k] for k in ("matrix_s", "components_s",
                                          "bfs_s", "sssp_s"))
    return out


def summary(want: dict) -> dict:
    """oracle()'s dict as JSON: counts in place of the arrays."""
    dist = want["dist"]
    finite = np.isfinite(dist)
    return dict(
        {k: val for k, val in want.items()
         if k not in ("labels", "reached", "traversed", "dist")},
        reached=want["reached"].sum(1).tolist(),
        traversed=want["traversed"].tolist(),
        edges_traversed=int(want["traversed"].sum()),
        sssp_reached=finite.sum(1).tolist(),
        sssp_dist_sum=[float(d[f].astype(np.float64).sum())
                       for d, f in zip(dist, finite)])


def main() -> int:
    from ..io import corpus
    from .bench_lj import WEIGHT_SEED, out_degrees, roots, sources
    from .make_lj_replica import NAME
    from .scale_tier import emit, log
    t0 = time.perf_counter()
    ec = corpus.load(NAME, fetch=False)
    if ec is None:
        emit({"note": f"no {NAME} under {corpus.graph_dir()}; run python -m "
              "vectorgraphlibrary_tpu_torch.apps.make_lj_replica first"})
        return 1
    if ec.weights is None:
        ec = ec.with_random_weights(WEIGHT_SEED)
    load_s = time.perf_counter() - t0
    log(f"loaded |V|={ec.vertices_count:,} |E|={ec.edges_count:,} "
        f"({load_s:.1f} s)")
    deg = out_degrees(ec)
    want = oracle(ec, sources(deg)[1], roots(deg)[1])
    print(json.dumps(dict(summary(want), graph=NAME, v=ec.vertices_count,
                          e=ec.edges_count, load_s=load_s)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
