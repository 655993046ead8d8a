"""PyTorch port, loading the JAX package's slim shards (persistence.
load_graph_from_binary_file through load_sharded_graph and streaming.
load_streamed). Such a file keeps the advance route and drops the CSRs; the
port rebuilds both from the route (route_build.csrs_from_route).

Two graphs, both packages' files from the same seeds: the JAX slim fixture
of tests/test_torch_sharded_slim.py (RMAT-10, average degree 8, seed 5, 2
shards) and RMAT-11 (average degree 8, seed 7, 3 shards) with a huge-row
threshold of 32 and chunks of 16 slots, so that many rows span several
chunks. The rebuilt row_ptr, col_idx, degrees and in_route_slots equal the
unslimmed file's load exactly, so every scan over them is bit-equal to the
scan over the unslimmed load; the scans equal the JAX package's slim scans
at test_torch_sharded_slim.py's tolerances (PageRank rtol 1e-5, the rest
exactly)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from vectorgraphlibrary_tpu.config import VGLConfig as JConfig
from vectorgraphlibrary_tpu.graph import persistence as jpersistence
from vectorgraphlibrary_tpu.io import generation as jgen
from vectorgraphlibrary_tpu.models import common
from vectorgraphlibrary_tpu.parallel import shard_build as jsb
from vectorgraphlibrary_tpu.parallel import sharded as jsh

from vectorgraphlibrary_tpu_torch.config import VGLConfig
from vectorgraphlibrary_tpu_torch.graph import persistence
from vectorgraphlibrary_tpu_torch.io import generation
from vectorgraphlibrary_tpu_torch.parallel import shard_build as sb
from vectorgraphlibrary_tpu_torch.parallel import sharded, streaming

PR_ITERS = 25
GRAPHS = {
    "rmat10": (dict(scale=10, avg_degree=8, seed=5), 2, {}),
    "rmat11_huge": (dict(scale=11, avg_degree=8, seed=7), 3,
                    dict(huge_degree_threshold=32, huge_row_chunk=16)),
}
CSR = ("row_ptr", "col_idx", "degrees")


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """built(name): the graph's JAX slim and full files, the port's full
    files of the same graph, its EdgesContainer and the JAX slim shards,
    made at the first call."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _build(name, tmp_path_factory.mktemp(name))
        return cache[name]
    return get


def _build(name, d):
    graph, n_shards, cfg = GRAPHS[name]
    ec = jgen.rmat(weighted=False, **graph)
    out = dict(name=name, ec=ec, n_shards=n_shards,
               pec=generation.rmat(weighted=False, **graph))
    for slim in (True, False):
        jsg = jsb.import_sharded(ec, n_shards, cfg=JConfig(**cfg), slim=slim)
        prefix = str(d / f"jax_{'slim' if slim else 'full'}")
        jpersistence.save_sharded_graph(jsg, prefix)
        out["jslim" if slim else "jfull"] = prefix
        if slim:
            out["jsg"] = jsg
    sg = sb.import_sharded(out["pec"], n_shards, cfg=VGLConfig(**cfg),
                           device="cpu")
    out["port"] = str(d / "port_full")
    persistence.save_sharded_graph(sg, out["port"])
    return out


def _shards_equal(got, want):
    assert len(got) == len(want)
    for s, (a, b) in enumerate(zip(got, want)):
        for f in ("outgoing", "incoming"):
            x, y = getattr(a, f), getattr(b, f)
            for k in CSR:
                assert torch.equal(getattr(x, k), getattr(y, k)), (s, f, k)
            assert (x.e, x.e_pad, x.v, x.v_pad) == (y.e, y.e_pad, y.v,
                                                    y.v_pad)
        assert torch.equal(a.in_route_slots, b.in_route_slots), s


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_rebuilt_csrs_equal_the_unslimmed_load(built, graph):
    files = built(graph)
    got = persistence.load_sharded_graph(files["jslim"], device="cpu")
    for g in got.shards:
        assert g.slim and g.advance_route is None
        for dg in (g.outgoing, g.incoming):
            assert all(b.adj is None for b in dg.buckets)
            assert dg.huge is None or dg.huge.adj is None
            assert dg.sorted_to_orig is None and dg.orig_to_sorted is None
    if files["name"] == "rmat11_huge":
        huge = got.shard(0).incoming.huge
        assert huge is not None and huge.n_chunks > huge.n_rows
    # the unslimmed file read as slim_value_pull leaves a shard (each
    # col_idx cut at its own edges)
    for prefix in (files["jfull"], files["port"]):
        want = [persistence.load_graph_from_binary_file(
            f"{prefix}.shard{s}.npz", device="cpu", slim=True)
            for s in range(files["n_shards"])]
        _shards_equal(got.shards, want)


def _roots(ec):
    return common.select_random_source(ec, seed=4), int(np.argmax(
        np.bincount(ec.src_ids, minlength=ec.vertices_count)))


def _port_scan(name, sg, ec):
    src, hub = _roots(ec)
    if name == "pagerank":
        return [sharded.pagerank_sharded_scan(sg, ec, PR_ITERS)]
    if name == "bfs":
        return [sharded.bfs_sharded_scan(sg, src)]
    if name == "cc_hybrid":
        return list(sharded.cc_hybrid_sharded_scan(sg, hub))
    return list(sharded.sssp_sharded_scan_hash(sg, src, True))


def _jax_scan(name, jsg, ec):
    src, hub = _roots(ec)
    if name == "pagerank":
        return [jsh.pagerank_sharded_scan(jsg, ec, PR_ITERS)]
    if name == "bfs":
        return [jsh.bfs_sharded_scan(jsg, jnp.int32(src))]
    if name == "cc_hybrid":
        return list(jsh.cc_hybrid_sharded_scan(jsg, jnp.int32(hub)))
    return list(jsh.sssp_sharded_scan_hash(jsg, jnp.int32(src), True))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


SCANS = ["pagerank", "bfs", "cc_hybrid", "sssp_hash"]


@pytest.mark.parametrize("name", SCANS)
def test_scans_equal_the_jax_slim_scans(built, name):
    """On the slim fixture, against the JAX package's slim shards."""
    files = built("rmat10")
    ec = files["ec"]
    got = _port_scan(name, persistence.load_sharded_graph(files["jslim"],
                                                          device="cpu"), ec)
    want = _jax_scan(name, files["jsg"], ec)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if name == "pagerank":
            np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5, atol=1e-9)
        else:
            np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("name", SCANS)
def test_scans_bit_equal_the_unslimmed_load(built, graph, name):
    files = built(graph)
    ec = files["ec"]
    got = _port_scan(name, persistence.load_sharded_graph(files["jslim"],
                                                          device="cpu"), ec)
    want = _port_scan(name, persistence.load_sharded_graph(files["jfull"],
                                                           device="cpu"), ec)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_load_streamed_equals_the_ports_own_files(built, graph):
    files = built(graph)
    got = streaming.load_streamed(files["jslim"], device="cpu")
    want = streaming.load_streamed(files["port"], device="cpu")
    assert (got.v, got.v_pad, got.e, got.n_shards, got.edges_per_shard) == \
        (want.v, want.v_pad, want.e, want.n_shards, want.edges_per_shard)
    for a, b in zip(got.shards, want.shards):
        for f in ("outgoing", "incoming"):
            for k in CSR:
                assert torch.equal(getattr(getattr(a, f), k),
                                   getattr(getattr(b, f), k)), (f, k)
    rev, dmask = sharded.pr_consts(files["ec"])
    pad = got.v_pad - len(rev)
    rev, dmask = np.pad(rev, (0, pad)), np.pad(dmask, (0, pad))
    assert torch.equal(streaming.pagerank_streamed(got, rev, dmask, PR_ITERS),
                       streaming.pagerank_streamed(want, rev, dmask,
                                                   PR_ITERS))


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_jax_slim_keys_are_the_ports_full_keys_less_the_dropped(built, graph,
                                                                tmp_path):
    """What lets chip_smoke.py make JAX slim files on a card without JAX:
    save_jax_slim_sharded of the port's full files holds exactly the JAX
    slim files' keys, and loads to the same shards."""
    files = built(graph)
    prefix = str(tmp_path / "stripped")
    persistence.save_jax_slim_sharded(files["port"], prefix)
    for s in range(files["n_shards"]):
        with np.load(f"{files['jslim']}.shard{s}.npz") as z:
            want = set(z.files)
        with np.load(f"{prefix}.shard{s}.npz") as z:
            got = set(z.files)
        with np.load(f"{files['port']}.shard{s}.npz") as z:
            full = set(z.files)
        assert got == want, (sorted(got ^ want))
        dropped = full - got
        assert all(k.split(".")[0] in ("out", "in") for k in dropped)
        assert {k.split(".")[-1] for k in dropped} == {
            "row_ptr", "col_idx", "degrees", "sorted_to_orig",
            "orig_to_sorted", "adj"}
    _shards_equal(persistence.load_sharded_graph(prefix, device="cpu").shards,
                  persistence.load_sharded_graph(files["jslim"],
                                                 device="cpu").shards)


@pytest.mark.parametrize("drop", ["stage_and_word_masks", "route_meta",
                                  "one_csr_key"])
def test_a_file_without_what_the_rebuild_needs_raises(built, tmp_path, drop):
    files = built("rmat10")
    with np.load(f"{files['jslim']}.shard0.npz") as z:
        kept = {k: z[k] for k in z.files}
    if drop == "stage_and_word_masks":
        for k in ("in_masks", "out_masks", "lane_idx", "mid_words",
                  "big_words"):
            kept.pop(f"route.{k}", None)
        match = "neither stage masks nor word masks"
    elif drop == "route_meta":
        kept.pop("route.meta")
        match = "neither a full file nor a slim shard"
    else:
        # a full file less one CSR array is neither package's
        with np.load(f"{files['jfull']}.shard0.npz") as z:
            kept = {k: z[k] for k in z.files if k != "in.degrees"}
        match = "in.degrees"
    path = str(tmp_path / "broken.npz")
    np.savez(path, **kept)
    with pytest.raises(ValueError, match=match):
        persistence.load_graph_from_binary_file(path, device="cpu")
