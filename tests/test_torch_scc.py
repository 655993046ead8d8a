"""PyTorch port, strongly connected components: vgl_forward_backward against
the JAX package's on RMAT-10, RU-9, RMAT-7, a graph with self-loops and a
path graph (labels equal exactly, and equal as components to seq_scc), the
step trace's shape, undirected_value_pull and the import without an advance
route, and the app's CLI contract. The JAX package runs as its own tests run
it (tests/conftest.py: routed paths, Pallas in interpret mode)."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorgraphlibrary_tpu.graph.device import import_graph as jimport_graph
from vectorgraphlibrary_tpu.io import generation
from vectorgraphlibrary_tpu.io.edges_container import EdgesContainer
from vectorgraphlibrary_tpu.models import common as jcommon
from vectorgraphlibrary_tpu.models import scc as jscc

from vectorgraphlibrary_tpu_torch.graph import persistence
from vectorgraphlibrary_tpu_torch.graph.device import import_graph as timport_graph
from vectorgraphlibrary_tpu_torch.models import common as tcommon
from vectorgraphlibrary_tpu_torch.models import scc as tscc
from vectorgraphlibrary_tpu_torch.ops.cuda import pull_reduce as pl
from vectorgraphlibrary_tpu_torch.ops.cuda import route_gather as rg
from vectorgraphlibrary_tpu_torch.utils.verify import equal_components

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPHS = ["small_rmat", "small_ru", "tiny", "selfloops", "path"]


def _path_graph():
    """tests/test_algorithms.py's path of 60 vertices plus a triangle."""
    n = 60
    src = np.concatenate([np.arange(n - 1), [n, n + 1, n + 2]]).astype(np.int32)
    dst = np.concatenate([np.arange(1, n), [n + 1, n + 2, n]]).astype(np.int32)
    return EdgesContainer(src, dst, n + 3)


def _selfloop_graph():
    """tests/test_torch_host.py's random graph with 50 self-loops."""
    rng = np.random.default_rng(0)
    v, e = 900, 9000
    src = rng.integers(0, v, e).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    src[:50] = dst[:50]
    return EdgesContainer(src, dst, v)


@pytest.fixture(scope="module")
def graphs(request):
    cache = {}

    def get(name):
        if name not in cache:
            ec = {"path": _path_graph, "selfloops": _selfloop_graph,
                  "tiny": lambda: generation.rmat(scale=7, avg_degree=4,
                                                  seed=17)}.get(name)
            ec = ec() if ec else request.getfixturevalue(name)
            cache[name] = (ec, jimport_graph(ec), timport_graph(ec, device="cpu"))
        return cache[name]
    return get


@pytest.mark.parametrize("graph", GRAPHS)
def test_forward_backward_matches_jax_and_oracle(graphs, graph):
    ec, jg, tg = graphs(graph)
    trace = []
    got = tscc.vgl_forward_backward(tg, trace=trace)
    want = jscc.vgl_forward_backward(jg)
    assert got.direction.name == want.direction.name == "ORIGINAL"
    assert got.values.dtype == torch.int32
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    assert equal_components(got.values.numpy()[:tg.v], tscc.seq_scc(ec)) == 0
    assert bool((got.values[tg.v:] == tg.v).all())          # padding
    # the trace: trim rounds end on a round that trims nothing, each pivot
    # round floods twice, and the last pivot leaves nothing
    kinds = [k for k, _ in trace]
    assert kinds[0] == "trim" and kinds[-1] == "pivot" and trace[-1][1] == 0
    for i, (kind, n) in enumerate(trace):
        if kind == "trim" and (i + 1 == len(trace)
                               or trace[i + 1][0] != "trim"):
            assert n == 0
    assert kinds.count("flood") == 2 * kinds.count("pivot")


def test_max_pivots_stops_early(graphs):
    _, jg, tg = graphs("path")
    got = tscc.vgl_forward_backward(tg, max_pivots=1)
    want = jscc.vgl_forward_backward(jg, max_pivots=1)
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))


def test_forward_backward_launches_no_kernel_on_the_cpu(graphs):
    _, _, tg = graphs("tiny")
    pl.pull_reduce.launches = rg.route_gather_finish.launches = 0
    tscc.vgl_forward_backward(tg)
    assert pl.pull_reduce.launches == rg.route_gather_finish.launches == 0


@pytest.mark.parametrize("combine,dtype", [("min", np.int32), ("or", np.int32),
                                           ("add", np.int32),
                                           ("add", np.float32),
                                           ("or", np.bool_)])
def test_undirected_value_pull_matches_jax(graphs, combine, dtype):
    _, jg, tg = graphs("selfloops")
    rng = np.random.default_rng(5)
    if dtype == np.bool_:
        x = rng.random(tg.v_pad) < 0.1
    elif dtype == np.float32:
        x = rng.random(tg.v_pad).astype(np.float32)
    else:
        x = rng.integers(-2**31, 2**31 - 1, tg.v_pad, dtype=np.int64) \
            .astype(np.int32)
    got = tcommon.undirected_value_pull(tg, torch.from_numpy(x), combine)
    want = np.asarray(jcommon.undirected_value_pull(jg, x, combine))
    assert got.numpy().dtype == want.dtype
    if dtype == np.float32:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("graph", ["small_rmat", "path"])
def test_import_without_advance_route(graphs, graph, tmp_path):
    """build_route=False: no advance route, the same vertex routes (the
    pulls and the SCC labels are unchanged), and a save that refuses the
    graph before it writes anything."""
    ec, _, tg = graphs(graph)
    ng = timport_graph(ec, device="cpu", build_route=False)
    assert ng.advance_route is None and ng.out_slots == ng.in_slots == 0
    for attr in ("vertex_route_s_from_g", "vertex_route_s_from_o",
                 "vertex_route_g_from_o"):
        assert torch.equal(getattr(ng, attr).fwd_idx,
                           getattr(tg, attr).fwd_idx)
        assert torch.equal(getattr(ng, attr).inv_idx,
                           getattr(tg, attr).inv_idx)
    assert torch.equal(tscc.vgl_forward_backward(ng).values,
                       tscc.vgl_forward_backward(tg).values)
    path = tmp_path / "g.npz"
    with pytest.raises(ValueError, match="build_route"):
        persistence.save_graph_to_binary_file(ng, str(path))
    assert not path.exists()


def test_app_cli_contract():
    out = subprocess.run(
        [sys.executable, "-m", "vectorgraphlibrary_tpu_torch.apps.scc", "-s",
         "10", "-e", "8", "-it", "2", "-check", "-dev", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "AVG_PERF:" in out.stdout
    assert out.stdout.count("error count: 0") == 2
