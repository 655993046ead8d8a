"""PyTorch port, the one-card sharded runners (*_sharded_scan) against the
JAX package on its sharded fixture (RMAT-10, average degree 8, seed 3,
weighted, 8 shards): the JAX *_sharded_scan and the JAX make_*_sharded on
the 8-device virtual CPU mesh (conftest), Pallas in interpret mode.
PageRank and HITS within rtol 1e-5 (HITS atol 1e-6 of the maximum); BFS
levels, CC labels and SSSP distances exactly, and the same counts of
iterations where the reference returns them."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from vectorgraphlibrary_tpu.io import generation as jgen
from vectorgraphlibrary_tpu.parallel import sharded as jsh
from vectorgraphlibrary_tpu.parallel import shard_build as jsb
from vectorgraphlibrary_tpu.parallel.mesh import make_mesh as jmake_mesh

from vectorgraphlibrary_tpu_torch.graph.device import import_graph
from vectorgraphlibrary_tpu_torch.graph.edges import build_edge_array_from_host
from vectorgraphlibrary_tpu_torch.io import generation
from vectorgraphlibrary_tpu_torch.models import common, pr as prm
from vectorgraphlibrary_tpu_torch.models import sssp as ssspm
from vectorgraphlibrary_tpu_torch.parallel import sharded
from vectorgraphlibrary_tpu_torch.parallel import shard_build as sb

N_SHARDS = 8
PR_ITERS = 30
HITS_ITERS = 10


def _hits_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def ref():
    """The JAX package's results: scan and shard_map runners."""
    ec = jgen.rmat(scale=10, avg_degree=8, seed=3, weighted=True)
    hosts = []
    jsg = jsb.import_sharded(ec, N_SHARDS, _host_out=hosts)
    mesh = jmake_mesh(N_SHARDS, 1)
    wst = jsb.shard_edge_values(ec.weights, jsg, ec, hosts)
    bfs_src = common.select_random_source(ec, seed=1)
    sssp_src = common.select_random_source(ec, seed=5)
    out = dict(bfs_src=bfs_src, sssp_src=sssp_src)
    out["pr_scan"] = np.asarray(jsh.pagerank_sharded_scan(jsg, ec, PR_ITERS))
    out["pr_map"] = np.asarray(jsh.make_pr_sharded(
        jsg, mesh, ec, max_iterations=PR_ITERS)())
    a, h = jsh.hits_sharded_scan(jsg, HITS_ITERS)
    out["hits_scan"] = (np.asarray(a), np.asarray(h))
    a, h = jsh.make_hits_sharded(jsg, mesh, HITS_ITERS)(jsg.stacked)
    out["hits_map"] = (np.asarray(a), np.asarray(h))
    out["bfs_scan"] = np.asarray(jsh.bfs_sharded_scan(jsg, jnp.int32(bfs_src)))
    out["bfs_map"] = np.asarray(jsh.make_bfs_sharded(jsg, mesh)(
        jsg.stacked, jnp.int32(bfs_src)))
    labels, iters = jsh.cc_sharded_scan(jsg)
    out["cc_scan"] = (np.asarray(labels), int(iters))
    out["cc_map"] = np.asarray(jsh.make_cc_sharded(jsg, mesh)(jsg.stacked))
    dist, iters = jsh.sssp_sharded_scan(jsg, wst, jnp.int32(sssp_src))
    out["sssp_scan"] = (np.asarray(dist), int(iters))
    dist, iters = jsh.sssp_sharded_scan(jsg, wst, jnp.int32(sssp_src), False)
    out["sssp_scan_all"] = (np.asarray(dist), int(iters))
    out["sssp_map"] = np.asarray(jsh.make_sssp_sharded(jsg, mesh, wst)(
        jsg.stacked, wst, jnp.int32(sssp_src)))
    return out


@pytest.fixture(scope="module")
def port():
    ec = generation.rmat(scale=10, avg_degree=8, seed=3, weighted=True)
    hosts = []
    sg = sb.import_sharded(ec, N_SHARDS, device="cpu", _host_out=hosts)
    return ec, sg, sb.shard_edge_values(ec.weights, sg, ec, hosts)


def test_pagerank_scan(ref, port):
    ec, sg, _ = port
    got = sharded.pagerank_sharded_scan(sg, ec, PR_ITERS)
    assert got.shape == (sg.v_pad,) and got.dtype == torch.float32
    for key in ("pr_scan", "pr_map"):
        np.testing.assert_allclose(got.numpy(), ref[key], rtol=1e-5,
                                   atol=1e-9, err_msg=key)


def test_pagerank_scan_equals_the_unsharded_graph(port):
    ec, sg, _ = port
    got = sharded.pagerank_sharded_scan(sg, ec, PR_ITERS)
    g = import_graph(ec, device="cpu")
    want = prm.vgl_page_rank(g, max_iterations=PR_ITERS,
                             use_convergence=False)[0]
    from vectorgraphlibrary_tpu_torch.graph.vertices import as_original_numpy
    np.testing.assert_allclose(got[:sg.v].numpy(), as_original_numpy(want, g),
                               rtol=1e-5, atol=1e-9)


def test_hits_scan(ref, port):
    _, sg, _ = port
    auth, hub = sharded.hits_sharded_scan(sg, HITS_ITERS)
    for key in ("hits_scan", "hits_map"):
        _hits_close(auth.numpy(), ref[key][0])
        _hits_close(hub.numpy(), ref[key][1])


def test_bfs_scan(ref, port):
    _, sg, _ = port
    got = sharded.bfs_sharded_scan(sg, ref["bfs_src"])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref["bfs_scan"])
    np.testing.assert_array_equal(got.numpy(), ref["bfs_map"])
    assert int((got > 0).sum()) > 1


def test_cc_scan(ref, port):
    _, sg, _ = port
    labels, iters = sharded.cc_sharded_scan(sg)
    np.testing.assert_array_equal(labels.numpy(), ref["cc_scan"][0])
    np.testing.assert_array_equal(labels.numpy(), ref["cc_map"])
    assert iters == ref["cc_scan"][1]


@pytest.mark.parametrize("partial", [True, False])
def test_sssp_scan(ref, port, partial):
    ec, sg, weights = port
    dist, iters = sharded.sssp_sharded_scan(sg, weights, ref["sssp_src"],
                                            partial=partial)
    want, want_iters = ref["sssp_scan" if partial else "sssp_scan_all"]
    np.testing.assert_array_equal(dist.numpy(), want)
    np.testing.assert_array_equal(dist.numpy(), ref["sssp_map"])
    assert iters == want_iters
    assert bool(torch.isfinite(dist).any())


def test_sssp_scan_equals_the_unsharded_graph(ref, port):
    ec, sg, weights = port
    host = []
    g = import_graph(ec, device="cpu", _host_out=host)
    ea = build_edge_array_from_host(ec.weights, g, host[0], host[1])
    want, _ = ssspm.vgl_dijkstra_all_active(g, ea, ref["sssp_src"])
    from vectorgraphlibrary_tpu_torch.graph.vertices import as_original_numpy
    dist, _ = sharded.sssp_sharded_scan(sg, weights, ref["sssp_src"])
    np.testing.assert_array_equal(dist[:sg.v].numpy(),
                                  as_original_numpy(want, g))
