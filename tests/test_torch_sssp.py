"""PyTorch port, the SSSP slice end to end: the four SSSP entry points
against the JAX package's on weighted RMAT-10, RU-9 and a path graph —
distances bit for bit (every message is one f32 addition and min is exact,
so the Bellman-Ford fixpoint has one answer whatever the schedule) and the
same iteration counts — against the sequential oracle, and the app's CLI
contract. The JAX package runs as its own tests run it (tests/conftest.py:
routed paths, Pallas in interpret mode)."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorgraphlibrary_tpu.graph.device import import_graph as jimport_graph
from vectorgraphlibrary_tpu.graph.edges import (
    build_edge_array_from_host as jbuild_edge_array)
from vectorgraphlibrary_tpu.io.edges_container import EdgesContainer
from vectorgraphlibrary_tpu.models import sssp as jsssp

from vectorgraphlibrary_tpu_torch.graph.device import import_graph as timport_graph
from vectorgraphlibrary_tpu_torch.graph.edges import (
    build_edge_array_from_host as tbuild_edge_array)
from vectorgraphlibrary_tpu_torch.graph.vertices import as_original_numpy
from vectorgraphlibrary_tpu_torch.models import common as tcommon
from vectorgraphlibrary_tpu_torch.models import sssp as tsssp
from vectorgraphlibrary_tpu_torch.ops.cuda import pull_reduce as pl
from vectorgraphlibrary_tpu_torch.ops.cuda import scatter_combine as sc
from vectorgraphlibrary_tpu_torch.utils.verify import verify_results

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPHS = ["small_rmat", "small_ru", "path"]


def _path_graph():
    """tests/test_algorithms.py's path of 60 vertices plus a triangle."""
    n = 60
    src = np.concatenate([np.arange(n - 1), [n, n + 1, n + 2]]).astype(np.int32)
    dst = np.concatenate([np.arange(1, n), [n + 1, n + 2, n]]).astype(np.int32)
    return EdgesContainer(src, dst, n + 3)


@pytest.fixture(scope="module")
def graphs(request):
    """name -> (ec, JAX graph, JAX EdgeArray, port graph, port EdgeArray,
    source), built once."""
    cache = {}

    def get(name):
        if name not in cache:
            ec = (_path_graph() if name == "path"
                  else request.getfixturevalue(name))
            ec = ec.with_random_weights(seed=13)
            jhost, thost = [], []
            jg = jimport_graph(ec, _host_out=jhost)
            jea = jbuild_edge_array(ec.weights, jg, jhost[0], jhost[1])
            tg = timport_graph(ec, device="cpu", _host_out=thost)
            tea = tbuild_edge_array(ec.weights, tg, thost[0], thost[1])
            src = 0 if name == "path" else tcommon.select_random_source(
                ec, seed=7)
            cache[name] = (ec, jg, jea, tg, tea, src)
        return cache[name]
    return get


# entry point -> (port call, JAX call), both (graph, weights, source) ->
# (VertexArray, iters)
VARIANTS = {
    "all_active": (tsssp.vgl_dijkstra_all_active,
                   jsssp.vgl_dijkstra_all_active),
    "partial_active": (tsssp.vgl_dijkstra_partial_active,
                       jsssp.vgl_dijkstra_partial_active),
    "partial_device": (tsssp.vgl_dijkstra_partial_device,
                       jsssp.vgl_dijkstra_partial_device),
    "partial_device-64-512": (
        lambda g, w, s: tsssp.vgl_dijkstra_partial_device(
            g, w, s, id_cap=64, edge_cap=512),
        lambda g, w, s: jsssp.vgl_dijkstra_partial_device(
            g, w, s, id_cap=64, edge_cap=512)),
}


@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_sssp_matches_jax_and_oracle(graphs, graph, variant):
    ec, jg, jea, tg, tea, src = graphs(graph)
    port, ref = VARIANTS[variant]
    got, iters = port(tg, tea, src)
    want, jiters = ref(jg, jea, src)
    assert got.values.dtype == torch.float32
    assert got.direction.name == want.direction.name
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    assert iters == jiters and isinstance(iters, int)
    assert verify_results(as_original_numpy(got, tg),
                          tsssp.seq_dijkstra(ec, src)) == 0
    # every variant reaches the all-active fixpoint, bit for bit
    full, _ = tsssp.vgl_dijkstra_all_active(tg, tea, src)
    np.testing.assert_array_equal(as_original_numpy(got, tg),
                                  as_original_numpy(full, tg))


@pytest.mark.parametrize("graph", ["small_rmat", "small_ru"])
@pytest.mark.parametrize("all_active", [True, False, None])
def test_sssp_multi_matches_jax_and_single(graphs, graph, all_active):
    ec, jg, jea, tg, tea, _ = graphs(graph)
    srcs = [tcommon.select_random_source(ec, seed=s) for s in (1, 4, 9)]
    got = tsssp.vgl_dijkstra_multi(tg, tea, srcs, all_active=all_active)
    want = jsssp.vgl_dijkstra_multi(jg, jea, srcs, all_active=all_active)
    assert got.direction.name == want.direction.name == "GATHER"
    assert got.values.shape == (3, tg.v_pad)
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    for i, s in enumerate(srcs):
        single, _ = tsssp.vgl_dijkstra_partial_device(tg, tea, s)
        assert torch.equal(got.values[i], single.values)


def test_partial_device_takes_both_branches(graphs):
    """At small capacities both the sparse push (every tier) and the dense
    pull run; the trace names one branch per sweep; on the CPU no kernel is
    launched."""
    ec, _, _, tg, tea, src = graphs("small_rmat")
    pl.pull_reduce.launches = sc.scatter_combine.launches = 0
    trace = []
    _, iters = tsssp.vgl_dijkstra_partial_device(tg, tea, src, id_cap=64,
                                                 edge_cap=512, trace=trace)
    assert len(trace) == iters
    assert {t[0] for t in trace} == {"push", "dense"}
    assert all(t[1:] in {(8, 64), (64, 512)} for t in trace
               if t[0] == "push")
    assert trace[0] == ("push", 8, 64)
    assert pl.pull_reduce.launches == sc.scatter_combine.launches == 0


def test_iteration_cap_stops_the_sweeps(graphs):
    ec, _, _, tg, tea, src = graphs("path")
    _, full = tsssp.vgl_dijkstra_all_active(tg, tea, src)
    assert full > 50            # one hop of the path per sweep
    dist, iters = tsssp.vgl_dijkstra_all_active(tg, tea, src,
                                                max_iterations=5)
    assert iters == 5
    assert int(torch.isfinite(dist.values).sum()) == 6
    _, iters = tsssp.vgl_dijkstra_partial_active(tg, tea, src,
                                                 max_iterations=5)
    assert iters == 5


@pytest.mark.parametrize("flag", ["default", "-all-active", "-partial-active",
                                  "-pull"])
def test_app_cli_contract(flag):
    args = [] if flag == "default" else [flag]
    out = subprocess.run(
        [sys.executable, "-m", "vectorgraphlibrary_tpu_torch.apps.sssp", "-s",
         "10", "-e", "8", "-it", "2", "-check", "-dev", "cpu", *args],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "AVG_PERF:" in out.stdout
    assert out.stdout.count("error count: 0") == 2
