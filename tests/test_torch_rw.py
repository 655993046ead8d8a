"""PyTorch port, random walks: vgl_random_walk held to the reference's
properties (tests/test_algorithms2.py:92-117) on RMAT-10 with weights, RU-9
and a graph with sinks: every step follows an edge or stays on a vertex
without out-edges, every end lies in seq_random_walk_reachable (equal to the
JAX package's), the same seed gives the same walks; and the app's CLI
contract. The JAX package's walks come from another random stream and are
not compared."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorgraphlibrary_tpu.io.edges_container import EdgesContainer
from vectorgraphlibrary_tpu.models import rw as jrw

from vectorgraphlibrary_tpu_torch.graph.device import import_graph as timport_graph
from vectorgraphlibrary_tpu_torch.models import common
from vectorgraphlibrary_tpu_torch.models import rw as trw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPHS = ["small_rmat", "small_ru", "sinks"]


def _sink_graph():
    """A binary tree of 63 vertices, edges towards the leaves: every walk
    ends on a leaf within 5 steps and then stays there."""
    src = (np.arange(1, 63) - 1) // 2
    return EdgesContainer(src.astype(np.int32), np.arange(1, 63, dtype=np.int32),
                          63)


@pytest.fixture(scope="module")
def graphs(request):
    cache = {}

    def get(name):
        if name not in cache:
            ec = _sink_graph() if name == "sinks" else \
                request.getfixturevalue(name).with_random_weights(seed=21)
            cache[name] = (ec, timport_graph(ec, device="cpu"))
        return cache[name]
    return get


@pytest.mark.parametrize("length", [1, 4, 10])
@pytest.mark.parametrize("graph", GRAPHS)
def test_walks_follow_edges_and_end_in_reach(graphs, graph, length):
    ec, tg = graphs(graph)
    src = 0 if graph == "sinks" else common.select_random_source(ec, seed=41)
    walkers = np.full(64, src, np.int64)
    finals, paths = trw.vgl_random_walk(tg, walkers, walk_length=length,
                                        seed=7, store_walk_paths=True)
    assert paths.shape == (64, length + 1)
    np.testing.assert_array_equal(paths[:, 0], walkers)
    np.testing.assert_array_equal(paths[:, -1], finals)
    np.testing.assert_array_equal(
        trw.vgl_random_walk(tg, walkers, walk_length=length, seed=7), finals)
    edges = set(zip(ec.src_ids.tolist(), ec.dst_ids.tolist()))
    outdeg = np.bincount(ec.src_ids, minlength=ec.vertices_count)
    for p in paths:
        for a, b in zip(p[:-1], p[1:]):
            assert (int(a), int(b)) in edges or (outdeg[a] == 0 and a == b)
    ok = trw.seq_random_walk_reachable(ec, src, length)
    np.testing.assert_array_equal(
        ok, jrw.seq_random_walk_reachable(ec, src, length))
    assert ok[finals].all()
    if graph == "sinks" and length == 10:
        assert (outdeg[finals] == 0).all()


def test_walkers_spread_over_the_out_neighbours(graphs):
    """64 walkers one step from the tree's root take both children."""
    _, tg = graphs("sinks")
    finals = trw.vgl_random_walk(tg, np.zeros(64, np.int64), walk_length=1,
                                 seed=3)
    assert set(finals.tolist()) == {1, 2}


def test_app_cli_contract():
    out = subprocess.run(
        [sys.executable, "-m", "vectorgraphlibrary_tpu_torch.apps.rw", "-s",
         "10", "-e", "8", "-it", "2", "-check", "-dev", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "AVG_PERF:" in out.stdout
    assert out.stdout.count("error count: 0") == 2
