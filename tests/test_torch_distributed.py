"""PyTorch port, the rank-parallel runners (parallel/sharded.make_*_sharded)
and the 2-D edge x vertex COO steps (parallel/distributed.py) on 2 and 4
gloo ranks on the CPU, each rank its own process joined through a file://
store (parallel/launch.py), on one thread, importing no JAX. Each rank
builds only its own shard of the JAX package's sharded fixture (RMAT-10,
average degree 8, seed 3, weighted); the results equal the port's scan
runners (rank 0 runs them; parallel/dryrun.run_dryrun holds them equal) and
the JAX package's *_sharded_scan: PageRank and HITS within rtol 1e-5 (HITS
atol 1e-6 of the maximum), BFS levels, CC labels and SSSP distances
exactly. The COO steps equal the JAX package's on a 2 x 2 mesh of its
virtual CPU devices. run_dryrun(2) passes at its own RMAT-9 shapes."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from vectorgraphlibrary_tpu.io import generation as jgen
from vectorgraphlibrary_tpu.models import common
from vectorgraphlibrary_tpu.parallel import distributed as JD
from vectorgraphlibrary_tpu.parallel import shard_build as jsb
from vectorgraphlibrary_tpu.parallel import sharded as jsh
from vectorgraphlibrary_tpu.parallel.edge_shard import (
    build_sharded_edge_graph as jbuild_edge_graph)
from vectorgraphlibrary_tpu.parallel.mesh import make_mesh as jmake_mesh

from vectorgraphlibrary_tpu_torch.parallel import dryrun

GRAPH = dict(scale=10, degree=8, seed=3)
PR_ITERS, HITS_ITERS, COO_STEPS = 30, 10, 3


@pytest.fixture(scope="module")
def ref():
    ec = jgen.rmat(scale=10, avg_degree=8, seed=3, weighted=True)
    src = common.select_random_source(ec, seed=1)
    hosts = []
    jsg = jsb.import_sharded(ec, 8, _host_out=hosts)
    wst = jsb.shard_edge_values(ec.weights, jsg, ec, hosts)
    auth, hub = jsh.hits_sharded_scan(jsg, HITS_ITERS)
    out = dict(
        source=src,
        pr=np.asarray(jsh.pagerank_sharded_scan(jsg, ec, PR_ITERS)),
        hits_auth=np.asarray(auth), hits_hub=np.asarray(hub),
        bfs=np.asarray(jsh.bfs_sharded_scan(jsg, jnp.int32(src))),
        cc=np.asarray(jsh.cc_sharded_scan(jsg)[0]),
        sssp=np.asarray(jsh.sssp_sharded_scan(jsg, wst, jnp.int32(src))[0]))
    # the COO steps on a 2 x 2 mesh, from the same starts as the ranks'
    mesh = jmake_mesh(2, 2, jax.devices()[:4])
    g = jbuild_edge_graph(ec, mesh)
    v_sh = NamedSharding(mesh, P("v"))
    ids = jnp.arange(g.v_pad)
    ranks = jax.device_put(jnp.where(ids < g.v, 1.0 / g.v, 0.0)
                           .astype(jnp.float32), v_sh)
    dist = jax.device_put(jnp.where(ids == src, 0.0, jnp.inf)
                          .astype(jnp.float32), v_sh)
    levels = jax.device_put(jnp.where(ids == src, 1, jnp.iinfo(jnp.int32).max)
                            .astype(jnp.int32), v_sh)
    pr_step, sssp_step = JD.make_pr_step(g, mesh), JD.make_sssp_step(g, mesh)
    bfs_step = JD.make_bfs_step(g, mesh)
    for i in range(COO_STEPS):
        ranks = pr_step(g.src, g.dst, g.out_degrees, ranks)
        dist = sssp_step(g.src, g.dst, g.weights, dist)
        levels = bfs_step(g.src, g.dst, levels, jnp.int32(i + 1))
    out.update(coo_pr=np.asarray(ranks), coo_sssp=np.asarray(dist),
               coo_bfs=np.asarray(levels))
    return out


def _hold_to_reference(results, ref):
    r = results[0]
    assert not bool(r["jax_loaded"])
    np.testing.assert_allclose(r["pr"], ref["pr"], rtol=1e-5, atol=1e-9)
    for key in ("hits_auth", "hits_hub"):
        np.testing.assert_allclose(r[key], ref[key], rtol=1e-5,
                                   atol=1e-6 * float(np.abs(ref[key]).max()))
    for key in ("bfs", "cc", "sssp"):
        np.testing.assert_array_equal(r[key], ref[key], err_msg=key)
    assert int((r["bfs"] > 0).sum()) > 1
    np.testing.assert_allclose(dryrun.assemble(results, "coo_pr"),
                               ref["coo_pr"], rtol=1e-5, atol=1e-9)
    for key in ("coo_sssp", "coo_bfs"):
        np.testing.assert_array_equal(dryrun.assemble(results, key), ref[key],
                                      err_msg=key)


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_rank_parallel_runners_and_coo_steps(ref, n_ranks):
    """run_dryrun holds every rank's results equal and equal to rank 0's
    scan runners; here they are held to the JAX package's. 4 ranks lay
    out the COO path as a 2 x 2 grid, 2 ranks as 1 x 2."""
    results = dryrun.run_dryrun(
        n_ranks, timeout=240, source=ref["source"], pr_iterations=PR_ITERS,
        hits_iterations=HITS_ITERS, coo_steps=COO_STEPS, **GRAPH)
    grids = sorted((int(r["e_index"]), int(r["v_index"])) for r in results)
    assert grids == ([(0, 0), (0, 1)] if n_ranks == 2
                     else [(0, 0), (0, 1), (1, 0), (1, 1)])
    _hold_to_reference(results, ref)


def test_run_dryrun_two_ranks():
    results = dryrun.run_dryrun(2, timeout=240)
    assert len(results) == 2
    assert results[0]["pr"].shape == results[0]["bfs"].shape
