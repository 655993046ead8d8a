"""PyTorch port, the scale-24 tier (vectorgraphlibrary_tpu_torch/apps/
build_scale24.py, bench_scale24.py, crosscheck_scale20.py) against the JAX
package's (apps/build_scale24.py, bench_scale24.py, crosscheck_scale20.py)
at RMAT-12, degree 8 (seed 42, unweighted). The JAX script writes under
<repo>/.cache, so its steps run here in-process: the shard-count loop,
import_sharded(slim=True) and save_sharded_graph into a temporary
directory; the port's builder runs as a process of its own. Equal exactly:
the meta (n_shards, v, v_pad, e, edges per shard), per shard and direction
row_ptr, col_idx, degrees and in_route_slots (the JAX shards loaded by the
port, their CSRs rebuilt from the advance route), the three vertex routes'
permutations, the PageRank constants; and plan_parts over dst % S parts
plans what import_sharded plans. bench_scale24.run on the CPU over the
port's artifact against the JAX scans over the JAX artifact: PageRank and
HITS within rtol 1e-5 (HITS with atol 1e-6 of the max), BFS and MS-BFS
levels, CC labels with its flood and hook counts, and hashed-SSSP
distances and sweeps exactly, every row under the JAX script's metric
name; PageRank error count 0 against seq_page_rank, BFS equal to
seq_top_down, CC's components equal to seq_cc's, and the full-size run's
host oracle (apps/exp_scale24_oracle.py) equal to the rows' reached
vertices, traversed edges and components. The cross-check app at
RMAT-10 prints ok. The apps' contract: exit 1 without an artifact, -dev
defaults to cuda, no tracked file changes (BENCH_SCALE24.json and
SCALE20_CROSSCHECK.json keep their bytes)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from vectorgraphlibrary_tpu.graph import persistence as jpersistence
from vectorgraphlibrary_tpu.io import generation as jgeneration
from vectorgraphlibrary_tpu.parallel import shard_build as jshard_build
from vectorgraphlibrary_tpu.parallel import sharded as jsharded

from vectorgraphlibrary_tpu_torch.apps import (bench_scale24, build_scale24,
                                               crosscheck_scale20,
                                               exp_scale24_oracle)
from vectorgraphlibrary_tpu_torch.graph import persistence
from vectorgraphlibrary_tpu_torch.io import generation
from vectorgraphlibrary_tpu_torch.models import bfs, cc, pr
from vectorgraphlibrary_tpu_torch.parallel import shard_build
from vectorgraphlibrary_tpu_torch.utils import verify

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE, DEGREE = 12, 8
ENV = dict(VGL_S24_SCALE=str(SCALE), VGL_S24_DEGREE=str(DEGREE))
PREFIX = f"rmat{SCALE}_{DEGREE}_slim"
_VROUTES = ("vertex_route_s_from_g", "vertex_route_s_from_o",
            "vertex_route_g_from_o")
JAX_METRICS = {f"{m}_rmat{SCALE}_{u}" for m, u in (
    ("pagerank", "mteps"), ("hits", "mteps"), ("bfs", "gteps"),
    ("bfs_msbfs", "gteps"), ("sssp_partial", "mteps"), ("cc_sv", "mteps"),
    ("cc_periter", "mteps"))} | {f"sssp_partial_rmat{SCALE}_periter_mteps"}


def _jax_build(cache) -> str:
    """apps/build_scale24.py's steps (lines 44-66) into `cache`."""
    ec = jgeneration.rmat(scale=SCALE, avg_degree=DEGREE, seed=42,
                          weighted=False)
    n_shards = 2
    while True:
        worst = jshard_build.estimated_shard_slots(ec, n_shards)
        if worst <= 1 << 28 or n_shards >= 16:
            break
        n_shards *= 2
    prefix = os.path.join(str(cache), PREFIX)
    jpersistence.save_sharded_graph(
        jshard_build.import_sharded(ec, n_shards, slim=True), prefix)
    rev, dmask = jsharded.pr_consts(ec)
    np.savez(f"{prefix}.prconsts.npz", rev=rev, dmask=dmask)
    return prefix


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """(port prefix, JAX prefix, the graph)."""
    cache = tmp_path_factory.mktemp("port_s24")
    r = subprocess.run(
        [sys.executable, "-m", "vectorgraphlibrary_tpu_torch.apps.build_scale24"],
        cwd=REPO, env=dict(os.environ, VGL_S24_CACHE=str(cache), **ENV),
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    summary = json.loads(r.stdout.strip().splitlines()[-1])
    assert summary["shards"] == 2 and summary["partition"] == "dst-mod"
    assert sum(summary["edges_per_shard"]) == summary["e"] == DEGREE << SCALE
    assert len(summary["shard_peak_rss_gib"]) == 2
    jax_ = _jax_build(tmp_path_factory.mktemp("jax_s24"))
    ec = generation.rmat(SCALE, DEGREE, seed=42, weighted=False)
    return os.path.join(str(cache), PREFIX), jax_, ec


@pytest.fixture(scope="module")
def loaded(built):
    port, jax_, _ = built
    return {name: persistence.load_sharded_graph(prefix, device="cpu")
            for name, prefix in (("port", port), ("jax", jax_))}


def test_meta_and_consts_are_the_jax_builders(built):
    port, jax_, ec = built
    metas = [json.load(open(f"{p}.meta.json")) for p in (port, jax_)]
    for key in ("n_shards", "v", "v_pad", "e", "edges_per_shard"):
        assert metas[0][key] == metas[1][key], key
    assert metas[0]["partition"] == "dst-mod"
    assert metas[0]["weighted"] is False and metas[0]["generator"] == "rmat"
    assert metas[0]["edges_per_shard"] == np.bincount(
        ec.dst_ids % metas[0]["n_shards"]).tolist()
    assert not any(name.startswith(PREFIX + ".weights")
                   for name in os.listdir(os.path.dirname(port)))
    with np.load(f"{port}.shard0.npz") as z:
        assert "route.meta" not in z.files and "in.col_idx" in z.files
    for name in ("rev", "dmask"):
        np.testing.assert_array_equal(
            np.load(f"{port}.prconsts.npz")[name],
            np.load(f"{jax_}.prconsts.npz")[name])


@pytest.mark.parametrize("n_shards", [2, 4])
def test_plan_parts_over_dst_mod_is_import_shardeds_plan(built, n_shards):
    _, _, ec = built
    want = shard_build._plan_shards(ec, n_shards)
    got = shard_build.plan_parts(
        [(ec.src_ids[m], ec.dst_ids[m]) for m in (
            ec.dst_ids % n_shards == s for s in range(n_shards))],
        ec.vertices_count)
    for key in ("n_shards", "edges_per_shard", "layout_out", "layout_in",
                "v_pad", "e_pad"):
        assert getattr(got, key) == getattr(want, key), key
    assert build_scale24.shard_count(ec) == 2


@pytest.mark.parametrize("s", range(2))
def test_shard_equals_the_jax_builders(loaded, s):
    a, b = loaded["port"].shard(s), loaded["jax"].shard(s)
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


@pytest.fixture(scope="module")
def jax_results(built):
    """The JAX script's scans (apps/bench_scale24.py:82-170) on its own
    artifact."""
    _, jax_, ec = built
    sg = jpersistence.load_sharded_graph(jax_)
    rev = np.load(f"{jax_}.prconsts.npz")["rev"]
    hub = int(np.argmax(np.where(rev > 0, 1.0 / np.maximum(rev, 1e-12), 0.0)))
    roots = jnp.asarray(np.random.default_rng(24).integers(
        0, sg.v, 32).astype(np.int32))
    labels, fl, hi = jsharded.cc_hybrid_sharded_scan(sg, jnp.int32(hub))
    dist, sweeps = jsharded.sssp_sharded_scan_hash(sg, jnp.int32(2))
    return {"pagerank": np.asarray(jsharded.pagerank_sharded_scan(
                sg, ec, max_iterations=10)),
            "hits": tuple(np.asarray(x) for x in
                          jsharded.hits_sharded_scan(sg, 5)),
            "bfs": np.asarray(jsharded.bfs_sharded_scan(sg, jnp.int32(2))),
            "msbfs": np.asarray(jsharded.msbfs_sharded_scan(sg, roots)),
            "sssp": (np.asarray(dist), int(sweeps)),
            "cc": (np.asarray(labels), int(fl), int(hi))}


@pytest.fixture(scope="module")
def port_run(built):
    """bench_scale24.run on the CPU over the port's artifact: (rows by
    metric, outputs by row)."""
    port, _, _ = built
    results = {}
    rows = bench_scale24.run(port, "cpu", results=results)
    return {r["metric"]: r for r in rows}, results


def _np(x):
    return tuple(_np(y) for y in x) if isinstance(x, tuple) else (
        x.numpy() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("algo", bench_scale24.ROWS)
def test_rows_match_the_jax_scans(port_run, jax_results, algo):
    rows, results = port_run
    got, want = _np(results[algo]), jax_results[algo]
    if algo == "pagerank":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)
        assert abs(rows[f"pagerank_rmat{SCALE}_mteps"]["ranks_sum"] - 1) \
            < 1e-4
    elif algo == "hits":
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-5,
                                       atol=1e-6 * np.abs(w).max())
    elif algo in ("sssp", "cc"):
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
    else:
        np.testing.assert_array_equal(got, want)


def test_rows_against_the_oracles(built, port_run):
    _, _, ec = built
    rows, results = port_run
    v = ec.vertices_count
    assert {m for m in rows if m != "resident_load"} == JAX_METRICS
    assert verify.verify_ranking_results(
        results["pagerank"][:v].numpy(),
        pr.seq_page_rank(ec, max_iterations=10, use_convergence=False)) == 0
    levels = results["bfs"][:v].numpy()
    np.testing.assert_array_equal(levels, bfs.seq_top_down(ec, 2))
    assert rows[f"bfs_rmat{SCALE}_gteps"]["reached"] == int((levels > 0).sum())
    labels = results["cc"][0][:v].numpy()
    assert verify.equal_components(labels, cc.seq_cc(ec)) == 0
    cc_row = rows[f"cc_sv_rmat{SCALE}_mteps"]
    assert cc_row["components"] == len(np.unique(cc.seq_cc(ec)))
    assert rows[f"cc_periter_rmat{SCALE}_mteps"]["sweeps"] == \
        2 * (cc_row["flood_levels"] + cc_row["hook_iters"]) == \
        cc_row["pull_steps"]
    # MS-BFS's traversed edges: the reached vertices' out-degrees without
    # self-loops, exactly
    roots = bench_scale24.roots_of(v)
    deg = np.bincount(ec.src_ids[ec.src_ids != ec.dst_ids], minlength=v)
    want = sum(int(deg[bfs.seq_top_down(ec, int(r)) > 0].sum())
               for r in roots)
    assert rows[f"bfs_msbfs_rmat{SCALE}_gteps"]["edges_traversed"] == want
    # the full-size run's host oracle on the same graph
    got = exp_scale24_oracle.oracle(ec)
    assert (got["reached_from_source"], got["msbfs_edges_traversed"],
            got["components"]) == (
        rows[f"bfs_rmat{SCALE}_gteps"]["reached"], want,
        cc_row["components"])
    assert rows[f"sssp_partial_rmat{SCALE}_mteps"]["reached"] == \
        got["reached_from_source"]
    for r in rows.values():
        assert r["device"] == "cpu" and r["value"] > 0


def _tracked() -> tuple:
    r = subprocess.run(["git", "status", "--porcelain"], cwd=REPO,
                       capture_output=True, text=True)
    files = tuple(open(os.path.join(REPO, n), "rb").read()
                  for n in ("BENCH_SCALE24.json", "SCALE20_CROSSCHECK.json"))
    return r.stdout if r.returncode == 0 else None, files


def test_apps_contract(built, tmp_path, monkeypatch, capsys):
    port, _, _ = built
    before = _tracked()
    for k, val in ENV.items():
        monkeypatch.setenv(k, val)
    monkeypatch.setenv("VGL_S24_CACHE", str(tmp_path))
    assert bench_scale24.main(["-dev", "cpu"]) == 1
    note = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "build_scale24" in note["note"]
    monkeypatch.setenv("VGL_S24_CACHE", os.path.dirname(port))
    assert bench_scale24.main(["-dev", "cpu", "bfs"]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    assert [r["metric"] for r in rows] == ["resident_load",
                                           f"bfs_rmat{SCALE}_gteps"]
    assert crosscheck_scale20.main(["-s", "10", "-dev", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["ok"] is True and out["scale"] == 10
    assert out["max_abs_err_scan_vs_oracle"] < 1e-6
    assert _tracked() == before
    for app in (bench_scale24, crosscheck_scale20):
        assert app.parser().parse_args([]).dev == "cuda"
