"""PyTorch port, HITS end to end: vgl_hits against the JAX package's on
RMAT-10, RU-9 and a path graph, against the sequential oracle, and the app's
CLI contract. The JAX package runs as its own tests run it (tests/conftest.py:
routed paths, Pallas in interpret mode).

Tolerance: rtol 1e-4 / atol 1e-7 after 20 iterations. Each iteration sums
every row's f32 messages and the squares of a whole vector in another order
than XLA does, and the normalised vectors feed the next iteration; the
largest difference measured here, printed by the test, is 5.3e-7 of the
vector's largest entry (RMAT-10, auth)."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorgraphlibrary_tpu.graph.device import import_graph as jimport_graph
from vectorgraphlibrary_tpu.io.edges_container import EdgesContainer
from vectorgraphlibrary_tpu.models import hits as jhits

from vectorgraphlibrary_tpu_torch.graph.device import import_graph as timport_graph
from vectorgraphlibrary_tpu_torch.models import hits as thits
from vectorgraphlibrary_tpu_torch.ops.cuda import pull_reduce as pl
from vectorgraphlibrary_tpu_torch.ops.cuda import route_gather as rg
from vectorgraphlibrary_tpu_torch.utils.verify import verify_ranking_results

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPHS = ["small_rmat", "small_ru", "path"]
FLAGS = ["default"]
TOL = dict(rtol=1e-4, atol=1e-7)


def _path_graph():
    """tests/test_algorithms.py's path of 60 vertices plus a triangle."""
    n = 60
    src = np.concatenate([np.arange(n - 1), [n, n + 1, n + 2]]).astype(np.int32)
    dst = np.concatenate([np.arange(1, n), [n + 1, n + 2, n]]).astype(np.int32)
    return EdgesContainer(src, dst, n + 3)


@pytest.fixture(scope="module")
def graphs(request):
    cache = {}

    def get(name):
        if name not in cache:
            ec = (_path_graph() if name == "path"
                  else request.getfixturevalue(name))
            cache[name] = (ec, jimport_graph(ec), timport_graph(ec, device="cpu"))
        return cache[name]
    return get


@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("iterations", [1, 20])
def test_hits_matches_jax_and_oracle(graphs, graph, iterations):
    ec, jg, tg = graphs(graph)
    got = thits.vgl_hits(tg, iterations=iterations)
    want = jhits.vgl_hits(jg, iterations=iterations)
    oracle = thits.seq_hits(ec, iterations=iterations)
    for name, g, w, o in zip(("auth", "hub"), got, want, oracle):
        assert g.direction.name == w.direction.name == "ORIGINAL"
        assert g.values.dtype == torch.float32
        gv, wv = g.values.numpy(), np.asarray(w.values)
        rel = np.abs(gv - wv).max() / max(np.abs(wv).max(), 1e-30)
        print(f"{graph} {iterations} iterations {name}: max abs diff / max "
              f"= {rel:.3e}")
        np.testing.assert_allclose(gv, wv, **TOL)
        assert bool((g.values[tg.v:] == 0).all())       # padding
        assert verify_ranking_results(gv[:tg.v], o) == 0
        if iterations == 20 and graph != "path":
            np.testing.assert_allclose(float((g.values ** 2).sum()), 1.0,
                                       rtol=1e-5)


def test_hits_launches_no_kernel_on_the_cpu(graphs):
    _, _, tg = graphs("small_ru")
    pl.pull_reduce.launches = rg.route_gather_finish.launches = 0
    thits.vgl_hits(tg, iterations=3)
    assert pl.pull_reduce.launches == rg.route_gather_finish.launches == 0


@pytest.mark.parametrize("flag", FLAGS)
def test_app_cli_contract(flag):
    args = [] if flag == "default" else [flag]
    out = subprocess.run(
        [sys.executable, "-m", "vectorgraphlibrary_tpu_torch.apps.hits", "-s",
         "10", "-e", "8", "-it", "2", "-check", "-dev", "cpu", *args],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "AVG_PERF:" in out.stdout
    assert out.stdout.count("error count: 0") == 4
