"""PyTorch port, the large tier's builder (vectorgraphlibrary_tpu_torch/apps/
build_scale25.py) against the JAX package's (apps/build_scale25.py): both
scripts run as processes of their own at scale 13, degree 8, 4 shards
(generator `rmat`, seed 42, weighted), and both artifacts are loaded by the
port (the JAX one's CSRs rebuilt from its advance route). Equal exactly:
the meta (e, v, v_pad, edges per shard, the partition), per shard and
direction row_ptr, col_idx, degrees and in_route_slots, the three vertex
routes' permutations, the weights in route-slot order and in CSR order,
and the PageRank constants. The port's scans on its artifact, resident and
streamed, against the JAX package's scans on its own artifact (the
tolerances of tests/test_torch_sharded_slim.py: PageRank within rtol 1e-5,
the rest exactly) and against the oracles as tests/test_scale_build.py holds
them (PageRank within atol 1e-6 of seq_page_rank, MS-BFS levels of two
roots equal to seq_top_down's, CC's components equal to seq_cc's, SSSP
error count 0 against seq_dijkstra)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from vectorgraphlibrary_tpu.graph import persistence as jpersistence
from vectorgraphlibrary_tpu.parallel import sharded as jsharded

from vectorgraphlibrary_tpu_torch.graph import persistence
from vectorgraphlibrary_tpu_torch.io import generation
from vectorgraphlibrary_tpu_torch.models import bfs, cc, pr, sssp
from vectorgraphlibrary_tpu_torch.parallel import sharded, streaming
from vectorgraphlibrary_tpu_torch.utils import verify

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE, DEGREE, SHARDS = 13, 8, 4
PR_ITERS = 25
ROOTS = np.arange(32, dtype=np.int32) * 7 + 1
SOURCE = 5
_VROUTES = ("vertex_route_s_from_g", "vertex_route_s_from_o",
            "vertex_route_g_from_o")


def _build(cmd, cache):
    env = dict(os.environ, VGL_S25_SCALE=str(SCALE),
               VGL_S25_DEGREE=str(DEGREE), VGL_S25_SHARDS=str(SHARDS),
               VGL_S25_WORKERS="2", VGL_S25_CACHE=str(cache),
               VGL_S25_GEN="rmat")
    r = subprocess.run([sys.executable, *cmd], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    return os.path.join(str(cache), f"rmat{SCALE}_{DEGREE}_slimw")


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """(port prefix, JAX prefix, the graph): both builders' artifacts."""
    port = _build(["-m", "vectorgraphlibrary_tpu_torch.apps.build_scale25"],
                  tmp_path_factory.mktemp("port_tier"))
    jax_ = _build([os.path.join(REPO, "apps", "build_scale25.py")],
                  tmp_path_factory.mktemp("jax_tier"))
    ec = generation.rmat(SCALE, DEGREE, seed=42, weighted=True)
    return port, jax_, ec


@pytest.fixture(scope="module")
def loaded(built):
    """Both artifacts loaded by the port on the CPU, with their weights."""
    port, jax_, _ = built
    out = {}
    for name, prefix in (("port", port), ("jax", jax_)):
        sg = persistence.load_sharded_graph(prefix, device="cpu")
        slot_w = persistence.load_sharded_weights(prefix, SHARDS, "cpu")
        out[name] = (sg, slot_w, sharded.slot_weights_stacked(slot_w, sg))
    return out


def test_meta_is_the_jax_builders(built):
    port, jax_, ec = built
    metas = [json.load(open(f"{p}.meta.json")) for p in (port, jax_)]
    for key in ("n_shards", "v", "v_pad", "e", "edges_per_shard",
                "partition", "route_n"):
        assert metas[0][key] == metas[1][key], key
    eps = metas[0]["edges_per_shard"]
    assert metas[0]["e"] == sum(eps) == ec.edges_count
    assert max(eps) < 1.5 * min(eps), eps
    assert metas[0]["partition"] == "dst-hash"
    assert metas[0]["generator"] == "rmat"
    # the port's slim shard: no advance route, each direction's CSR
    with np.load(f"{port}.shard0.npz") as z:
        assert "route.meta" not in z.files and "in.col_idx" in z.files
    for name in ("rev", "dmask"):
        np.testing.assert_array_equal(
            np.load(f"{port}.prconsts.npz")[name],
            np.load(f"{jax_}.prconsts.npz")[name])


@pytest.mark.parametrize("s", range(SHARDS))
def test_shard_equals_the_jax_builders(loaded, s):
    (pg, pw, pws), (jg, jw, jws) = loaded["port"], loaded["jax"]
    a, b = pg.shard(s), jg.shard(s)
    assert (a.v, a.v_pad, a.out_slots, a.in_slots) == \
        (b.v, b.v_pad, b.out_slots, b.in_slots)
    for d in ("outgoing", "incoming"):
        da, db = getattr(a, d), getattr(b, d)
        assert da.e == db.e
        for key in ("row_ptr", "degrees"):
            assert torch.equal(getattr(da, key), getattr(db, key)), (d, key)
        assert torch.equal(da.col_idx[:da.e], db.col_idx[:db.e]), d
    assert torch.equal(a.in_route_slots, b.in_route_slots)
    for attr in _VROUTES:
        assert torch.equal(getattr(a, attr).fwd_idx,
                           getattr(b, attr).fwd_idx), attr
    # the weights in route-slot order (the files) and in CSR order
    assert torch.equal(pw[s], jw[s])
    assert torch.equal(pws[s].incoming.flat, jws[s].incoming.flat)


@pytest.fixture(scope="module")
def jax_results(built):
    """The JAX package's scans on its own artifact."""
    _, jax_, ec = built
    sg = jpersistence.load_sharded_graph(jax_)
    wst = jsharded.slot_weights_stacked(
        jpersistence.load_sharded_weights(jax_, SHARDS))
    hub = int(np.argmax(np.bincount(ec.src_ids, minlength=sg.v)))
    return hub, {
        "pagerank": np.asarray(jsharded.pagerank_sharded_scan(
            sg, ec, max_iterations=PR_ITERS)),
        "msbfs": np.asarray(jsharded.msbfs_sharded_scan(
            sg, jnp.asarray(ROOTS))),
        "cc": np.asarray(jsharded.cc_hybrid_sharded_scan(
            sg, jnp.int32(hub))[0]),
        "sssp": np.asarray(jsharded.sssp_sharded_scan(
            sg, wst, jnp.int32(SOURCE))[0])}


def _port_run(built, loaded, how, algo, hub):
    port, _, _ = built
    if how == "resident":
        sg, _, weights = loaded["port"]
        with np.load(f"{port}.prconsts.npz") as z:
            rev, dmask = z["rev"], z["dmask"]
        calls = {
            "pagerank": lambda: sharded.pagerank_sharded_scan_consts(
                sg, rev, dmask, PR_ITERS),
            "msbfs": lambda: sharded.msbfs_sharded_scan(sg, ROOTS),
            "cc": lambda: sharded.cc_hybrid_sharded_scan(sg, hub)[0],
            "sssp": lambda: sharded.sssp_sharded_scan(sg, weights,
                                                      SOURCE)[0]}
    else:
        ssg = streaming.load_streamed(port, weights=True, device="cpu")
        with np.load(f"{port}.prconsts.npz") as z:
            rev, dmask = z["rev"], z["dmask"]
        calls = {
            "pagerank": lambda: streaming.pagerank_streamed(
                ssg, rev, dmask, PR_ITERS),
            "msbfs": lambda: streaming.msbfs_streamed(ssg, ROOTS)[0],
            "cc": lambda: streaming.cc_hybrid_streamed(ssg, hub)[0],
            "sssp": lambda: streaming.sssp_streamed(ssg, SOURCE)[0]}
    return calls[algo]().numpy()


@pytest.mark.parametrize("how", ["resident", "streamed"])
@pytest.mark.parametrize("algo", ["pagerank", "msbfs", "cc", "sssp"])
def test_scans_match_jax_and_oracles(built, loaded, jax_results, algo, how):
    _, _, ec = built
    hub, want = jax_results
    got = _port_run(built, loaded, how, algo, hub)
    v = ec.vertices_count
    if algo == "pagerank":
        np.testing.assert_allclose(got, want[algo], rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(got[:v], pr.seq_page_rank(
            ec, max_iterations=PR_ITERS, use_convergence=False), atol=1e-6)
    elif algo == "msbfs":
        np.testing.assert_array_equal(got, want[algo])
        for r in (0, 31):
            np.testing.assert_array_equal(got[r, :v].astype(np.int32),
                                          bfs.seq_top_down(ec, int(ROOTS[r])))
    elif algo == "cc":
        np.testing.assert_array_equal(got, want[algo])
        assert verify.equal_components(got[:v], cc.seq_cc(ec)) == 0
    else:
        np.testing.assert_array_equal(got, want[algo])
        assert verify.verify_results(got[:v],
                                     sssp.seq_dijkstra(ec, SOURCE)) == 0
