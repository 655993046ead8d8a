"""Multi-rank dry run on the CPU (port of
vectorgraphlibrary_tpu/parallel/dryrun.py:18-120): the distributed paths
on small shapes, on gloo ranks, without a card.

    python -m vectorgraphlibrary_tpu_torch.parallel.dryrun [N]

run_dryrun(n) spawns n ranks (parallel/launch.py). Each builds its own
shard of RMAT-9 (average degree 8, seed 1, weighted) and runs PageRank,
BFS, SSSP, CC and HITS through the rank-parallel runners
(sharded.make_*_sharded); rank 0 also builds every shard (import_sharded)
and runs the same five through the one-card scan runners, which must give
the same values (bit for bit, HITS within rtol 1e-5). As the reference's
dry run (dryrun.py:41-85), every rank then runs the partial-active SSSP
(delta_capacity 128), DO-BFS (id_cap 2^8, edge_cap 2^12), MS-BFS from
roots 0 to 31, flood-hybrid CC from hub 0 and one GraphSAGE step (in 4,
hidden 8, 3 classes, Adam 1e-2), with the reference's checks; their
results equal on every rank, the SSSP and DO-BFS equal the all-active
SSSP and pull BFS, and MS-BFS and CC hybrid equal rank 0's scan twins.
Then every rank takes a few PageRank, SSSP and BFS steps of the 2-D edge
x vertex COO path (distributed.py) on the reference's factorization of the
ranks.
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
# distribution part 2: equal on every rank
PART2 = ("sssp_partial", "bfs_do", "msbfs", "cc_hybrid", "cc_hybrid_counts",
         "sage_loss")
SAGE_F, SAGE_HIDDEN, SAGE_CLASSES = 4, 8, 3


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


def _part2(g, mesh, w, device, source: int) -> dict:
    """The rank drivers of distribution part 2 and one GraphSAGE step."""
    from ..models import gnn
    labels, flood, hooks = sharded.make_cc_hybrid_sharded(g, mesh)(0)
    rng = np.random.default_rng(0)
    feats = torch.from_numpy(rng.normal(size=(g.v_pad, SAGE_F)).astype(
        np.float32)).to(device)
    classes = torch.from_numpy(rng.integers(0, SAGE_CLASSES, g.v_pad).astype(
        np.int32)).to(device)
    mask = torch.from_numpy(rng.random(g.v_pad) < 0.5).to(device)
    params = gnn.init_sage(torch.Generator(device).manual_seed(0), SAGE_F,
                           SAGE_HIDDEN, SAGE_CLASSES)
    step = sharded.make_sage_train_step_sharded(
        g, mesh, torch.optim.Adam(params.parameters(), lr=1e-2))
    return dict(
        sssp_partial=sharded.make_sssp_sharded_partial(
            g, mesh, w, delta_capacity=128)(source),
        bfs_do=sharded.make_bfs_do_sharded(g, mesh, id_cap=1 << 8,
                                           edge_cap=1 << 12)(source),
        msbfs=sharded.make_msbfs_sharded(g, mesh)(torch.arange(32)),
        cc_hybrid=labels, cc_hybrid_counts=np.asarray([flood, hooks]),
        sage_loss=step(params, feats, classes, mask))


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
    out.update(_part2(g, mesh, w, device, source))
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
            scan_hits_hub=hub,
            scan_msbfs=sharded.msbfs_sharded_scan(sg, torch.arange(32)),
            scan_cc_hybrid=sharded.cc_hybrid_sharded_scan(sg, 0)[0])
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
    for r in results:
        for key in PART2:
            np.testing.assert_array_equal(r[key], first[key],
                                          err_msg=f"{key} differs by rank")
    for key, want in (("sssp_partial", "sssp"), ("bfs_do", "bfs"),
                      ("msbfs", "scan_msbfs"), ("cc_hybrid",
                                                "scan_cc_hybrid")):
        np.testing.assert_array_equal(first[key], first[want],
                                      err_msg=f"{key} != {want}")
    # the reference's checks
    _check(bool(np.isfinite(first["sssp_partial"]).any()),
           "partial SSSP reached no vertex")
    _check(int((first["bfs_do"] > 0).sum()) >= 1, "DO-BFS reached no vertex")
    _check(first["msbfs"].shape == (32, first["pr"].shape[0])
           and int((first["msbfs"] > 0).sum()) >= 32,
           "MS-BFS levels of the wrong shape or roots unreached")
    _check(int(first["cc_hybrid_counts"][0]) >= 1, "CC hybrid never flooded")
    _check(bool(np.isfinite(first["sage_loss"])), "GraphSAGE loss not finite")
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
