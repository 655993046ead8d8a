"""Multi-rank dry run on the CPU (port of
vectorgraphlibrary_tpu/parallel/dryrun.py:18-120): the distributed paths
on small shapes, on gloo ranks, without a card.

    python -m vectorgraphlibrary_tpu_torch.parallel.dryrun [N]

run_dryrun(n) spawns n ranks (parallel/launch.py). Each builds its own
shard of RMAT-9 (average degree 8, seed 1, weighted) and runs PageRank,
BFS, SSSP, CC and HITS through the rank-parallel runners
(sharded.make_*_sharded); rank 0 also builds every shard (import_sharded)
and runs the same five through the one-card scan runners, which must give
the same values (bit for bit, HITS within rtol 1e-5); then every rank
takes a few PageRank, SSSP and BFS steps of the 2-D edge x vertex COO path
(distributed.py) on the reference's factorization of the ranks. The
reference's dry run also drives the sharded partial SSSP, DO-BFS, MS-BFS,
CC hybrid and GraphSAGE step, which the port has not taken yet.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..io import generation
from . import distributed as D
from . import sharded
from .edge_shard import build_sharded_edge_graph
from .launch import run_ranks
from .mesh import default_mesh, make_mesh
from .shard_build import (edge_values_of_shard, import_shard, import_sharded,
                          shard_edge_values)

ALGORITHMS = ("pr", "bfs", "sssp", "cc", "hits_auth", "hits_hub")


def _coo_steps(ec, device, source: int, steps: int) -> dict:
    """`steps` steps of each 2-D COO step from the single-source (or
    uniform) start; this rank's vertex range of each, and its place."""
    grid = default_mesh(device=device)
    g = build_sharded_edge_graph(ec, grid)
    v_local = g.v_pad // grid.n_vertex
    first = grid.v_index * v_local
    ids = torch.arange(first, first + v_local, device=device)
    ranks = torch.where(ids < g.v, 1.0 / g.v, 0.0).to(torch.float32)
    dist = torch.where(ids == source, 0.0, torch.inf).to(torch.float32)
    levels = torch.where(ids == source, 1, torch.iinfo(torch.int32).max) \
        .to(torch.int32)
    pr_step, sssp_step = D.make_pr_step(g, grid), D.make_sssp_step(g, grid)
    bfs_step = D.make_bfs_step(g, grid)
    for i in range(steps):
        ranks, dist = pr_step(ranks), sssp_step(dist)
        levels = bfs_step(levels, i + 1)
    return dict(coo_pr=ranks, coo_sssp=dist, coo_bfs=levels,
                e_index=grid.e_index, v_index=grid.v_index)


def sharded_rank(rank: int, world: int, device, scale: int = 9,
                 degree: int = 8, seed: int = 1, source: int = 0,
                 pr_iterations: int = 5, hits_iterations: int = 5,
                 coo_steps: int = 3) -> dict:
    """One rank of the dry run (parallel/launch.run_ranks calls it)."""
    ec = generation.rmat(scale=scale, avg_degree=degree, seed=seed,
                         weighted=True)
    mesh = make_mesh(world, 1, device)
    hosts = []
    g = import_shard(ec, world, rank, device=device, _host_out=hosts)
    w = edge_values_of_shard(ec.weights, ec, world, rank, g, hosts[0])
    auth, hub = sharded.make_hits_sharded(g, mesh, hits_iterations)()
    out = dict(
        pr=sharded.make_pr_sharded(g, mesh, ec,
                                   max_iterations=pr_iterations)(),
        bfs=sharded.make_bfs_sharded(g, mesh)(source),
        sssp=sharded.make_sssp_sharded(g, mesh, w)(source),
        cc=sharded.make_cc_sharded(g, mesh)(), hits_auth=auth, hits_hub=hub)
    out.update(_coo_steps(ec, device, source, coo_steps))
    if rank == 0:
        hs = []
        sg = import_sharded(ec, world, device=device, _host_out=hs)
        auth, hub = sharded.hits_sharded_scan(sg, hits_iterations)
        out.update(
            scan_pr=sharded.pagerank_sharded_scan(sg, ec, pr_iterations),
            scan_bfs=sharded.bfs_sharded_scan(sg, source),
            scan_sssp=sharded.sssp_sharded_scan(
                sg, shard_edge_values(ec.weights, sg, ec, hs), source)[0],
            scan_cc=sharded.cc_sharded_scan(sg)[0], scan_hits_auth=auth,
            scan_hits_hub=hub)
    out["jax_loaded"] = any(m.split(".")[0] in ("jax", "jaxlib",
                                                "vectorgraphlibrary_tpu")
                            for m in sys.modules)
    return {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in out.items()}


def assemble(results: list, key: str) -> np.ndarray:
    """The full [v_pad] state of a COO step from the ranks of edge index 0,
    in vertex-range order."""
    parts = sorted((int(r["v_index"]), r[key]) for r in results
                   if int(r["e_index"]) == 0)
    return np.concatenate([p for _, p in parts])


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun: {what}")


def run_dryrun(n_devices: int, timeout: float = 300.0, **kwargs) -> list:
    """Spawn n gloo ranks on the CPU, run the dry run and check it; returns
    every rank's results (sharded_rank's dict)."""
    results = run_ranks("vectorgraphlibrary_tpu_torch.parallel.dryrun:"
                        "sharded_rank", n_devices, device="cpu",
                        kwargs=kwargs, timeout=timeout)
    first = results[0]
    for r in results:
        _check(not bool(r["jax_loaded"]), "a rank imported JAX")
        for key in ALGORITHMS:
            np.testing.assert_array_equal(r[key], first[key],
                                          err_msg=f"{key} differs by rank")
    for key in ALGORITHMS:
        if key.startswith("hits"):
            # the hub pull runs over outgoing edges, whose sources lie in
            # every shard: its sums add the shards in another order
            np.testing.assert_allclose(
                first["scan_" + key], first[key], rtol=1e-5,
                atol=1e-6 * float(np.abs(first[key]).max()),
                err_msg=f"{key}: scan != ranks")
        else:
            np.testing.assert_array_equal(first["scan_" + key], first[key],
                                          err_msg=f"{key}: scan != ranks")
    s = float(first["pr"].sum())
    _check(0.5 < s < 1.5, f"PageRank sums to {s}")
    _check(int((first["bfs"] > 0).sum()) >= 1, "BFS reached no vertex")
    _check(bool(np.isfinite(first["sssp"]).any()), "SSSP reached no vertex")
    s = float(assemble(results, "coo_pr").sum())
    _check(0.5 < s < 1.5, f"the COO PageRank step sums to {s}")
    _check(bool(np.isfinite(assemble(results, "coo_sssp")).any()),
           "the COO SSSP steps reached no vertex")
    return results


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    run_dryrun(n)
    print(f"dryrun: {n} gloo ranks passed")
