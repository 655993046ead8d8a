"""PyTorch port, the LiveJournal-scale configuration
(vectorgraphlibrary_tpu_torch/apps/make_lj_replica.py, bench_lj.py,
exp_lj_oracle.py) against the JAX package's (apps/make_lj_replica.py,
apps/bench_lj.py) on reduced replicas of the same construction.

The root script, loaded by path, and the port's generator: the expected
degrees equal bit for bit at full size; with the script's V, E and MAX_DEG
patched to a reduced size, both write byte-identical files, where the
degree cap binds and where it does not. On the replica (3,001 vertices,
42,600 edges, weights from seed 7): the layouts that a vertex count off a
power of two and the Chung-Lu head give equal the JAX package's (v_pad,
degrees with repeated edges and self-loops counted, the degree classes);
vgl_dijkstra_multi (partial-active, also at push capacities that
overflow, and by default), vgl_cc_hybrid_multi and vgl_msbfs from
bench_lj's seeds equal the JAX package's exactly. bench_lj.run on the CPU
against the host oracle: component count, reached sets, traversed edges
and SSSP distances; the app's contract (exit 1 without the graph, -dev
defaults to the card, no tracked file changes) and the harness's real
tier picking the graph up by name."""
import importlib.util
import inspect
import json
import os
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorgraphlibrary_tpu.graph.device import import_graph as jimport_graph
from vectorgraphlibrary_tpu.graph.edges import (
    build_edge_array_from_host as jbuild_edge_array)
from vectorgraphlibrary_tpu.models import bfs as jbfs
from vectorgraphlibrary_tpu.models import cc as jcc
from vectorgraphlibrary_tpu.models import sssp as jsssp

from vectorgraphlibrary_tpu_torch.apps import (bench_lj, exp_lj_oracle,
                                               make_lj_replica, run_tests,
                                               scale_tier)
from vectorgraphlibrary_tpu_torch.graph.device import import_graph
from vectorgraphlibrary_tpu_torch.graph.edges import build_edge_array_from_host
from vectorgraphlibrary_tpu_torch.models import bfs, cc, sssp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: at these sizes torch's threads only wait on one
    another, and next to other busy processes (the suite's other workers)
    they made this module 15x slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SIZES = {"cap-binds": (3001, 42600, 200), "cap-free": (2048, 29000, 20000)}
SMALL = SIZES["cap-binds"]


def _script():
    """apps/make_lj_replica.py, loaded by its path."""
    spec = importlib.util.spec_from_file_location(
        "jax_make_lj_replica", os.path.join(REPO, "apps", "make_lj_replica.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_weights_equal_the_scripts_at_full_size():
    script = _script()
    for name in ("V", "E", "GAMMA", "MAX_DEG", "SEED"):
        assert getattr(make_lj_replica, name) == getattr(script, name)
    want, got = script.weights(), make_lj_replica.weights()
    assert got.dtype == want.dtype == np.float64 and got.shape == (4_847_571,)
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))


@pytest.mark.parametrize("size", list(SIZES))
def test_files_are_byte_identical(size, tmp_path, monkeypatch, capsys):
    v, e, max_deg = SIZES[size]
    script = _script()
    paths = {}
    for tag, mod in (("jax", script), ("port", make_lj_replica)):
        monkeypatch.setattr(mod, "V", v)
        monkeypatch.setattr(mod, "E", e)
        monkeypatch.setattr(mod, "MAX_DEG", max_deg)
        monkeypatch.setenv("VGL_GRAPH_DIR", str(tmp_path / tag))
        assert mod.main() == 0
        paths[tag] = tmp_path / tag / "lj-replica.el_container"
    jax_bytes = paths["jax"].read_bytes()
    assert jax_bytes == paths["port"].read_bytes()
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["sha256"] == make_lj_replica.sha256(str(paths["jax"]))
    assert summary["bytes"] == len(jax_bytes) == 9 + 24 + 8 * e
    # the cap binds where the uncapped head lies above it
    head = make_lj_replica.weights(v, e, max_deg=np.inf)[0]
    assert (head > max_deg) == (size == "cap-binds")
    # the in-memory graph is the file's, and main keeps a file it finds
    ec = make_lj_replica.replica(v, e, max_deg)
    assert ec.weights is None and ec.vertices_count == v
    ec.save_to_binary_file(str(tmp_path / "mem.el_container"))
    assert (tmp_path / "mem.el_container").read_bytes() == jax_bytes
    assert make_lj_replica.main() == 0


@pytest.fixture(scope="module")
def replica():
    """(weighted ec, JAX graph, JAX EdgeArray, port graph, port
    EdgeArray) of the small replica, weights as bench_lj gives them."""
    ec = make_lj_replica.replica(*SMALL).with_random_weights(
        bench_lj.WEIGHT_SEED)
    jhost, thost = [], []
    jg = jimport_graph(ec, _host_out=jhost)
    jea = jbuild_edge_array(ec.weights, jg, jhost[0], jhost[1])
    tg = import_graph(ec, device="cpu", _host_out=thost, build_route=False)
    tea = build_edge_array_from_host(ec.weights, tg, thost[0], thost[1])
    return ec, jg, jea, tg, tea


def test_layout_off_a_power_of_two_equals_jax(replica):
    """v = 3,001 pads as the JAX package pads it; the degrees (repeated
    edges and self-loops counted) and degree classes are the same."""
    ec, jg, _, tg, _ = replica
    assert (ec.src_ids == ec.dst_ids).any()
    key = ec.src_ids.astype(np.int64) * ec.vertices_count + ec.dst_ids
    assert len(np.unique(key)) < ec.edges_count        # repeated edges
    assert tg.v == ec.vertices_count and tg.v_pad == jg.v_pad > tg.v
    for d in ("outgoing", "incoming"):
        t, j = getattr(tg, d), getattr(jg, d)
        for f in ("row_ptr", "col_idx", "degrees", "sorted_to_orig",
                  "orig_to_sorted"):
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(j, f)))
        assert [(b.row_start, b.rows, b.width) for b in t.buckets] == \
            [(b.row_start, b.rows, b.width) for b in j.buckets]
        assert (t.huge is None) == (j.huge is None)
        if t.huge is not None:
            assert (t.huge.n_rows, t.huge.n_chunks, t.huge.chunk_w) == \
                (j.huge.n_rows, j.huge.n_chunks, j.huge.chunk_w)
    np.testing.assert_array_equal(
        tg.outgoing.degrees[:tg.v].numpy()[np.argsort(
            tg.outgoing.sorted_to_orig[:tg.v].numpy())],
        bench_lj.out_degrees(ec))


@pytest.mark.parametrize("all_active,caps", [
    (False, None), (False, (64, 1024)), (None, None)],
    ids=["partial", "partial-small-caps", "default"])
def test_sssp_multi_equals_jax(replica, all_active, caps):
    """At 42,600 edges the default is all-active (under 2^22, as in the
    JAX package); small push capacities overflow to the dense pull."""
    ec, jg, jea, tg, tea = replica
    srcs = bench_lj.sources(bench_lj.out_degrees(ec))[1]
    kw = {} if caps is None else dict(id_cap=caps[0], edge_cap=caps[1])
    got = sssp.vgl_dijkstra_multi(tg, tea, srcs, all_active=all_active, **kw)
    want = jsssp.vgl_dijkstra_multi(jg, jea, srcs, all_active=all_active,
                                    **kw)
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))


def test_cc_hybrid_multi_equals_jax(replica):
    ec, jg, _, tg, _ = replica
    hs = bench_lj.hubs(ec.vertices_count)[1]
    got = cc.vgl_cc_hybrid_multi(tg, hs).values
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jcc.vgl_cc_hybrid_multi(jg, hs).values))


def test_msbfs_equals_jax(replica):
    ec, jg, _, tg, _ = replica
    rts = bench_lj.roots(bench_lj.out_degrees(ec))[1]
    got = bfs.vgl_msbfs(tg, rts).values
    want_lv = np.asarray(jbfs.vgl_msbfs(jg, rts).values)
    assert got.shape == (64, tg.v_pad)
    np.testing.assert_array_equal(got.numpy(), want_lv)
    # the JAX script's count: (levels > 0) @ the outgoing degrees
    want = (want_lv > 0).astype(np.int64) \
        @ np.asarray(jg.outgoing.degrees).astype(np.int64)
    assert scale_tier.traversed_per_root(got, tg.outgoing.degrees) == \
        want.tolist()


@pytest.mark.parametrize("k", [64, 40])
def test_msbfs_pulls_count_the_or_pulls(replica, monkeypatch, k):
    """bench_lj.msbfs_pulls, read from the levels alone, is the number of
    or-pulls the call ran (a short last word padded with root 0)."""
    ec, _, _, tg, _ = replica
    rts = bench_lj.roots(bench_lj.out_degrees(ec))[1][:k]
    pulls = []
    real = bfs.advance_pull_value
    monkeypatch.setattr(bfs, "advance_pull_value",
                        lambda *a, **kw: pulls.append(1) or real(*a, **kw))
    levels = bfs.vgl_msbfs(tg, rts).values
    assert bench_lj.msbfs_pulls(levels) == len(pulls) > 2 * ((k + 31) // 32)


@pytest.mark.parametrize("size", list(SIZES))
def test_bench_rows_equal_the_oracle(size, capsys):
    ec = make_lj_replica.replica(*SIZES[size])
    results = {}
    rows = bench_lj.run(ec, "cpu", check_rows=True, results=results)
    by = {r["metric"]: r for r in rows}
    assert set(by) == {"import", "sssp_lj-replica_mteps",
                       "cc_lj-replica_mteps", "bfs_msbfs_lj-replica_gteps",
                       "check"}
    assert by["import"]["advance_route"] is False
    check = by["check"]
    assert check["ok"] and check["reached_mismatches"] == 0
    assert check["cc_errors"] == [0] * bench_lj.N_HUBS
    assert check["sssp_errors"] == [0] * bench_lj.N_SOURCES
    # the oracle on its own, from the same seeds
    wec = ec.with_random_weights(bench_lj.WEIGHT_SEED)
    deg = bench_lj.out_degrees(wec)
    want = exp_lj_oracle.oracle(wec, bench_lj.sources(deg)[1],
                                bench_lj.roots(deg)[1])
    assert by["cc_lj-replica_mteps"]["components"] == want["components"]
    assert check["components"] == [[want["components"]] * bench_lj.N_HUBS,
                                   want["components"]]
    assert want["labels"].shape == (ec.vertices_count,)
    ms = by["bfs_msbfs_lj-replica_gteps"]
    assert ms["pulls"]["timed"] == bench_lj.msbfs_pulls(results["msbfs"])
    assert ms["edges_traversed"] == int(want["traversed"].sum())
    assert ms["reached"] == want["reached"].sum(1).tolist()
    assert by["sssp_lj-replica_mteps"]["reached"] == \
        np.isfinite(want["dist"]).sum(1).tolist()
    summary = exp_lj_oracle.summary(want)
    assert summary["edges_traversed"] == ms["edges_traversed"]
    json.dumps(summary)
    # a wrong answer fails the check, in the first run or a later one
    graph = bench_lj.load(wec, "cpu")[1]
    good = results["cc"]
    for run, vertex in ((0, 0), (2, ec.vertices_count - 1)):
        results["cc"] = good.clone()
        results["cc"][run, vertex] = -5
        bad = bench_lj.check(wec, graph, results, want)
        assert not bad["ok"] and not bad["cc_ok"]
        assert [e > 0 for e in bad["cc_errors"]] == \
            [i == run for i in range(bench_lj.N_HUBS)]


def _tracked_changes() -> str:
    return subprocess.run(["git", "status", "--porcelain"], cwd=REPO,
                          capture_output=True, text=True).stdout


def test_app_contract(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("VGL_GRAPH_DIR", str(tmp_path))
    assert bench_lj.main(["-dev", "cpu"]) == 1
    assert "make_lj_replica" in json.loads(
        capsys.readouterr().out.strip().splitlines()[-1])["note"]
    assert bench_lj.parser().parse_args([]).dev == "cuda"
    assert inspect.signature(bench_lj.run).parameters["device"].default == \
        "cuda"
    for name, val in zip(("V", "E", "MAX_DEG"), SIZES["cap-free"]):
        monkeypatch.setattr(make_lj_replica, name, val)
    assert make_lj_replica.main() == 0
    capsys.readouterr()
    before = _tracked_changes()
    assert bench_lj.main(["-dev", "cpu", "-check", "cc", "msbfs"]) == 0
    assert _tracked_changes() == before
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    assert [r["metric"] for r in rows] == [
        "import", "cc_lj-replica_mteps", "bfs_msbfs_lj-replica_gteps",
        "check"]
    assert rows[-1]["ok"] and "sssp_ok" not in rows[-1]
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            bench_lj.main([])
    # the harness's real tier finds the graph by name
    found = run_tests.real_graph_corpus(["lj-replica"])
    assert found == [("load", str(tmp_path / "lj-replica.el_container"),
                      "lj-replica")]
