"""PyTorch port, SSWP end to end: vgl_widest_paths against the JAX package's
on weighted RMAT-10, RU-9 and a path graph — capacities bit for bit (every
message is one f32 min and max is exact) and the same iteration count —
against the sequential oracle, and the app's CLI contract. The JAX package
runs as its own tests run it (tests/conftest.py: routed paths, Pallas in
interpret mode)."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorgraphlibrary_tpu.graph.device import import_graph as jimport_graph
from vectorgraphlibrary_tpu.io.edges_container import EdgesContainer
from vectorgraphlibrary_tpu.graph.edges import (
    build_edge_array_from_host as jbuild_edge_array)
from vectorgraphlibrary_tpu.models import sswp as jsswp

from vectorgraphlibrary_tpu_torch.graph.device import import_graph as timport_graph
from vectorgraphlibrary_tpu_torch.graph.edges import (
    build_edge_array_from_host as tbuild_edge_array)
from vectorgraphlibrary_tpu_torch.graph.vertices import as_original_numpy
from vectorgraphlibrary_tpu_torch.models import common as tcommon
from vectorgraphlibrary_tpu_torch.models import sswp as tsswp
from vectorgraphlibrary_tpu_torch.utils.verify import verify_results

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPHS = ["small_rmat", "small_ru", "path"]
FLAGS = ["default"]


def _path_graph():
    """tests/test_algorithms.py's path of 60 vertices plus a triangle."""
    n = 60
    src = np.concatenate([np.arange(n - 1), [n, n + 1, n + 2]]).astype(np.int32)
    dst = np.concatenate([np.arange(1, n), [n + 1, n + 2, n]]).astype(np.int32)
    return EdgesContainer(src, dst, n + 3)


@pytest.fixture(scope="module")
def graphs(request):
    """name -> (ec, JAX graph, JAX EdgeArray, port graph, port EdgeArray),
    built once."""
    cache = {}

    def get(name):
        if name not in cache:
            ec = (_path_graph() if name == "path"
                  else request.getfixturevalue(name))
            ec = ec.with_random_weights(seed=11)
            jhost, thost = [], []
            jg = jimport_graph(ec, _host_out=jhost)
            jea = jbuild_edge_array(ec.weights, jg, jhost[0], jhost[1])
            tg = timport_graph(ec, device="cpu", _host_out=thost)
            tea = tbuild_edge_array(ec.weights, tg, thost[0], thost[1])
            cache[name] = (ec, jg, jea, tg, tea)
        return cache[name]
    return get


@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("seed", [1, 6])
def test_sswp_matches_jax_and_oracle(graphs, graph, seed):
    ec, jg, jea, tg, tea = graphs(graph)
    src = seed if graph == "path" else tcommon.select_random_source(
        ec, seed=seed)
    got, iters = tsswp.vgl_widest_paths(tg, tea, src)
    want, jiters = jsswp.vgl_widest_paths(jg, jea, src)
    assert got.values.dtype == torch.float32
    assert got.direction.name == want.direction.name == "GATHER"
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    assert iters == jiters and isinstance(iters, int)
    caps = as_original_numpy(got, tg)
    assert verify_results(caps, tsswp.seq_widest_paths(ec, src)) == 0
    assert caps[src] == np.inf
    # padding rows stay at 0: an empty row's -inf never survives the max
    assert bool((got.values[tg.v:] == 0).all())


def test_iteration_cap_stops_the_sweeps(graphs):
    ec, _, _, tg, tea = graphs("path")
    _, full = tsswp.vgl_widest_paths(tg, tea, 0)
    assert full > 50            # one hop of the path per sweep
    caps, iters = tsswp.vgl_widest_paths(tg, tea, 0, max_iterations=4)
    assert iters == 4
    assert int((caps.values > 0).sum()) == 5


@pytest.mark.parametrize("flag", FLAGS)
def test_app_cli_contract(flag):
    args = [] if flag == "default" else [flag]
    out = subprocess.run(
        [sys.executable, "-m", "vectorgraphlibrary_tpu_torch.apps.sswp", "-s",
         "10", "-e", "8", "-it", "2", "-check", "-dev", "cpu", *args],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "AVG_PERF:" in out.stdout
    assert out.stdout.count("error count: 0") == 2
