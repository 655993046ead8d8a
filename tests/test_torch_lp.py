"""PyTorch port, label propagation: vgl_label_propagation against the JAX
package's (its routed step, tests/conftest.py) on RMAT-7, the RMAT-10 hub
graph (rows past the huge-degree threshold), RU-9 and a graph with
self-loops, labels and iteration counts equal exactly; the vectorised oracle
against the reference's loop oracle; and the app's CLI contract."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorgraphlibrary_tpu.graph.device import import_graph as jimport_graph
from vectorgraphlibrary_tpu.io import generation
from vectorgraphlibrary_tpu.io.edges_container import EdgesContainer
from vectorgraphlibrary_tpu.models import lp as jlp

from vectorgraphlibrary_tpu_torch.graph.device import import_graph as timport_graph
from vectorgraphlibrary_tpu_torch.models import lp as tlp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# graph -> max_iterations (tests/test_algorithms3.py: 4 on RMAT-7, 3 on the
# hub graph; 20 runs RU-9 and the self-loop graph to convergence or the cap)
CASES = {"tiny": 4, "small_rmat": 3, "small_ru": 20, "selfloops": 20}


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
            ec = {"selfloops": _selfloop_graph,
                  "tiny": lambda: generation.rmat(scale=7, avg_degree=4,
                                                  seed=17)}.get(name)
            ec = ec() if ec else request.getfixturevalue(name)
            cache[name] = (ec, jimport_graph(ec), timport_graph(ec, device="cpu"))
        return cache[name]
    return get


@pytest.mark.parametrize("graph", list(CASES))
def test_label_propagation_matches_jax_and_oracle(graphs, graph):
    ec, jg, tg = graphs(graph)
    n_it = CASES[graph]
    if graph == "small_rmat":
        assert jg.incoming.huge is not None and jg.incoming.huge.n_rows > 0
    labels, iters = tlp.vgl_label_propagation(tg, max_iterations=n_it)
    jlabels, jiters = jlp.vgl_label_propagation(jg, max_iterations=n_it)
    assert iters == jiters and isinstance(iters, int)
    assert labels.direction.name == "ORIGINAL"
    assert labels.values.dtype == torch.int32
    np.testing.assert_array_equal(labels.values.numpy(),
                                  np.asarray(jlabels.values))
    np.testing.assert_array_equal(labels.values.numpy()[:tg.v],
                                  tlp.seq_label_propagation(ec, n_it))


@pytest.mark.parametrize("graph", list(CASES) + ["empty"])
@pytest.mark.parametrize("n_it", [1, 2, 20])
def test_fast_oracle_equals_loop_oracle(graphs, graph, n_it):
    ec = (EdgesContainer(np.zeros(0, np.int32), np.zeros(0, np.int32), 5)
          if graph == "empty" else graphs(graph)[0])
    np.testing.assert_array_equal(tlp.seq_label_propagation_fast(ec, n_it),
                                  tlp.seq_label_propagation(ec, n_it))


def test_app_cli_contract():
    out = subprocess.run(
        [sys.executable, "-m", "vectorgraphlibrary_tpu_torch.apps.lp", "-s",
         "10", "-e", "8", "-it", "2", "-check", "-dev", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "AVG_PERF:" in out.stdout
    assert out.stdout.count("error count: 0") == 2
