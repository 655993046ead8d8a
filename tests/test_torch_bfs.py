"""PyTorch port, the BFS slice end to end: every BFS entry point against the
JAX package's SCATTER-ordered levels, exactly, and against the sequential
oracle, on RMAT-10 and RU-9; the multi-root forms against per-root runs; and
the app's CLI contract. The JAX package runs as its own tests run it
(tests/conftest.py: routed paths, Pallas in interpret mode)."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorgraphlibrary_tpu.graph.device import import_graph as jimport_graph
from vectorgraphlibrary_tpu.models import bfs as jbfs
from vectorgraphlibrary_tpu.models import common as jcommon

from vectorgraphlibrary_tpu_torch.graph.device import import_graph as timport_graph
from vectorgraphlibrary_tpu_torch.graph.vertices import VertexArray, as_original_numpy
from vectorgraphlibrary_tpu_torch.models import bfs as tbfs
from vectorgraphlibrary_tpu_torch.models import common as tcommon
from vectorgraphlibrary_tpu_torch.utils.verify import verify_results

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPHS = ["small_rmat", "small_ru"]


@pytest.fixture(scope="module")
def graphs(request):
    cache = {}

    def get(name):
        if name not in cache:
            ec = request.getfixturevalue(name)
            cache[name] = (ec, jimport_graph(ec), timport_graph(ec, device="cpu"))
        return cache[name]
    return get


def _check_row(ec, tg, levels: torch.Tensor, src: int) -> None:
    got = as_original_numpy(VertexArray(values=levels, direction=tbfs.S), tg)
    assert verify_results(got, tbfs.seq_top_down(ec, src)) == 0


# entry point -> (port call, JAX call), both (graph, source) -> VertexArray
VARIANTS = {
    "top_down": (tbfs.vgl_top_down, jbfs.vgl_top_down),
    "bu": (lambda g, s: tbfs.vgl_bfs(g, s, alpha=1e-9),
           lambda g, s: jbfs.vgl_bfs(g, s, alpha=1e-9)),
    "do": (tbfs.vgl_bfs, jbfs.vgl_bfs),
    "device-1k-8k": (
        lambda g, s: tbfs.vgl_bfs_device(g, s, id_cap=1 << 10, edge_cap=1 << 13),
        lambda g, s: jbfs.vgl_bfs_device(g, s, id_cap=1 << 10, edge_cap=1 << 13)),
    "device-64-256": (
        lambda g, s: tbfs.vgl_bfs_device(g, s, id_cap=64, edge_cap=256),
        lambda g, s: jbfs.vgl_bfs_device(g, s, id_cap=64, edge_cap=256)),
}


@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_bfs_matches_jax_and_oracle(graphs, graph, variant):
    ec, jg, tg = graphs(graph)
    port, ref = VARIANTS[variant]
    src = tcommon.select_random_source(ec, seed=2)
    got = port(tg, src)
    assert got.direction == tbfs.S and got.values.dtype == torch.int32
    np.testing.assert_array_equal(got.values.numpy(),
                                  np.asarray(ref(jg, src).values))
    _check_row(ec, tg, got.values, src)


def test_device_bfs_takes_both_branches(graphs):
    """At the small capacities both the sparse push and the dense pull run,
    and the trace names one branch per level."""
    ec, _, tg = graphs("small_rmat")
    for seed in (2, 4):
        trace = []
        lv = tbfs.vgl_bfs_device(tg, tcommon.select_random_source(ec, seed=seed),
                                 id_cap=64, edge_cap=256, trace=trace)
        assert {t[0] for t in trace} == {"td", "bu"}
        assert len(trace) == int(lv.values.max())   # one level per step
        assert all(t[1:] in {(8, 64), (64, 256)} for t in trace
                   if t[0] == "td")


def test_bfs_device_multi_matches_single(graphs):
    ec, _, tg = graphs("small_rmat")
    roots = [tcommon.select_random_source(ec, seed=s) for s in (2, 4, 4)]
    multi = tbfs.vgl_bfs_device_multi(tg, roots, id_cap=1 << 10,
                                      edge_cap=1 << 13).values
    assert multi.shape == (3, tg.v_pad)
    for i, src in enumerate(roots):
        single = tbfs.vgl_bfs_device(tg, src, id_cap=1 << 10, edge_cap=1 << 13)
        assert torch.equal(multi[i], single.values)


def _ms_roots(ec, kind):
    if kind == "6-with-duplicate":
        roots = [jcommon.select_random_source(ec, seed=s) for s in (1, 2, 3, 5, 8)]
        return roots + [roots[0]]
    rng = np.random.default_rng(0)
    return [jcommon.select_random_source(ec, seed=int(s))
            for s in rng.integers(0, 1000, 33)]


@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("kind", ["6-with-duplicate", "33-two-words"])
def test_msbfs_matches_jax_and_oracle(graphs, graph, kind):
    ec, jg, tg = graphs(graph)
    roots = _ms_roots(ec, kind)
    got = tbfs.vgl_msbfs(tg, roots).values
    assert got.shape == (len(roots), tg.v_pad) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jbfs.vgl_msbfs(jg, roots).values))
    for i in (0, len(roots) // 2, len(roots) - 1):
        _check_row(ec, tg, got[i], roots[i])


@pytest.mark.parametrize("graph", GRAPHS)
def test_oracle_takes_a_list_of_sources(graphs, graph):
    """One row per source, each equal to that source's own call."""
    ec = graphs(graph)[0]
    srcs = [tcommon.select_random_source(ec, seed=s) for s in range(3)]
    rows = tbfs.seq_top_down(ec, srcs)
    assert rows.shape == (3, ec.vertices_count) and rows.dtype == np.int32
    for row, src in zip(rows, srcs):
        np.testing.assert_array_equal(row, tbfs.seq_top_down(ec, src))


@pytest.mark.parametrize("graph", GRAPHS)
def test_oracle_and_helpers_match_jax(graphs, graph):
    ec = graphs(graph)[0]
    for seed in range(3):
        src = tcommon.select_random_source(ec, seed=seed)
        np.testing.assert_array_equal(tbfs.seq_top_down(ec, src),
                                      jbfs.seq_top_down(ec, src))
    for x in list(range(-2, 70)) + [2**k + d for k in range(7, 33)
                                    for d in (-1, 0, 1)]:
        assert tcommon.next_pow2(x) == jcommon.next_pow2(x)


@pytest.mark.parametrize("flag", ["-td", "-bu", "default"])
def test_app_cli_contract(flag):
    args = [] if flag == "default" else [flag]
    out = subprocess.run(
        [sys.executable, "-m", "vectorgraphlibrary_tpu_torch.apps.bfs", "-s",
         "10", "-e", "8", "-it", "2", "-check", "-dev", "cpu", *args],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "AVG_PERF:" in out.stdout
    assert out.stdout.count("error count: 0") == 2


def test_app_without_card_raises():
    """-dev cuda (the default) raises where there is no card; it never falls
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so -dev cuda runs")
    out = subprocess.run(
        [sys.executable, "-m", "vectorgraphlibrary_tpu_torch.apps.bfs", "-s",
         "8", "-e", "4", "-it", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr
    assert "AVG_PERF" not in out.stdout
