"""PyTorch port, host streaming (parallel/streaming.py) against the JAX
package's streaming functions, from the same files: RMAT-10 (average degree
8, seed 3, weighted) in 4 shards and its route-slot weights, written by the
JAX package (save_sharded_graph, save_sharded_weights) and read by both,
device="cpu" (nothing to pin). PageRank within rtol 1e-5, HITS within rtol
1e-5 and atol 1e-6 of the maximum, MS-BFS levels, CC labels and SSSP
distances and every count exactly; each equals the port's resident scans on
the same files too; at most 2 shards are ever resident."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorgraphlibrary_tpu.graph import persistence as jpersistence
from vectorgraphlibrary_tpu.io import generation as jgen
from vectorgraphlibrary_tpu.models import common
from vectorgraphlibrary_tpu.parallel import shard_build as jsb
from vectorgraphlibrary_tpu.parallel import streaming as jstreaming

from vectorgraphlibrary_tpu_torch.graph import persistence
from vectorgraphlibrary_tpu_torch.parallel import sharded, streaming

N_SHARDS, PR_ITERS, HITS_ITERS = 4, 10, 5


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    ec = jgen.rmat(scale=10, avg_degree=8, seed=3, weighted=True)
    hosts = []
    jsg = jsb.import_sharded(ec, N_SHARDS, _host_out=hosts)
    wst = jsb.shard_edge_values(ec.weights, jsg, ec, hosts)
    prefix = str(tmp_path_factory.mktemp("streamed") / "rmat10")
    jpersistence.save_sharded_graph(jsg, prefix)
    jpersistence.save_sharded_weights(list(np.asarray(wst.incoming.slot_flat)),
                                      prefix)
    rev, dmask = sharded.pr_consts(ec)
    rng = np.random.default_rng(5)
    roots = np.array([common.select_random_source(ec, seed=int(s))
                      for s in rng.integers(0, 1000, 32)], np.int32)
    hub = int(np.argmax(np.bincount(ec.src_ids, minlength=ec.vertices_count)))
    return ec, prefix, rev, dmask, roots, hub


def _run(mod, ssg, name, case):
    ec, _, rev, dmask, roots, hub = case
    if name == "pagerank":
        pad = ssg.v_pad - len(rev)
        return [mod.pagerank_streamed(ssg, np.pad(rev, (0, pad)),
                                      np.pad(dmask, (0, pad)), PR_ITERS)]
    if name == "hits":
        return list(mod.hits_streamed(ssg, HITS_ITERS))
    if name == "msbfs":
        return list(mod.msbfs_streamed(ssg, roots))
    if name == "cc_hybrid":
        return list(mod.cc_hybrid_streamed(ssg, hub))
    return list(mod.sssp_streamed(ssg, int(roots[0])))


def _resident(name, sg, case):
    ec, prefix, _, _, roots, hub = case
    if name == "pagerank":
        return [sharded.pagerank_sharded_scan(sg, ec, PR_ITERS)]
    if name == "hits":
        return list(sharded.hits_sharded_scan(sg, HITS_ITERS))
    if name == "msbfs":
        return [sharded.msbfs_sharded_scan(sg, roots)]
    if name == "cc_hybrid":
        return list(sharded.cc_hybrid_sharded_scan(sg, hub))[:1]
    ws = sharded.slot_weights_stacked(
        persistence.load_sharded_weights(prefix, N_SHARDS, "cpu"), sg)
    return list(sharded.sssp_sharded_scan(sg, ws, int(roots[0]),
                                          partial=False))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _hold(name, got, want):
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        if name == "pagerank":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-9)
        elif name == "hits":
            np.testing.assert_allclose(g, w, rtol=1e-5,
                                       atol=1e-6 * float(np.abs(w).max()))
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", ["pagerank", "hits", "msbfs", "cc_hybrid",
                                  "sssp"])
def test_streamed_equals_jax_and_the_resident_scans(files, name):
    _, prefix = files[:2]
    ssg = streaming.load_streamed(prefix, weights=True, device="cpu")
    assert ssg.n_shards == N_SHARDS and all(g.slim for g in ssg.shards)
    got = _run(streaming, ssg, name, files)
    jssg = jstreaming.load_streamed(prefix, weights=True)
    _hold(name, got, _run(jstreaming, jssg, name, files))
    sg = persistence.load_sharded_graph(prefix, device="cpu")
    _hold(name, got, _resident(name, sg, files))
    assert ssg.peak_resident == 1 and ssg.resident == 0
    sweeps = len(ssg.sweep_s)
    assert sweeps >= 1 and ssg.h2d_bytes > 0
    if name == "cc_hybrid":
        # a flood level and a hook each copy every shard once
        assert sweeps == got[1] + got[2]
