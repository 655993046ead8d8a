"""PyTorch port, connected components end to end: Shiloach-Vishkin, the
flood hybrid (default hub, a bad hub, a flood cut short), its multi-hub form
and the BFS-based variant against the JAX package's on RMAT-10, RU-9 and a
path graph — labels AND iteration counts equal (integers: exact) where the
flood closes, least-id labels where it does not — against the sequential
oracle, and the app's CLI contract. The JAX package runs as
its own tests run it (tests/conftest.py: routed paths, Pallas in interpret
mode)."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorgraphlibrary_tpu.graph.device import import_graph as jimport_graph
from vectorgraphlibrary_tpu.io.edges_container import EdgesContainer
from vectorgraphlibrary_tpu.models import cc as jcc

from vectorgraphlibrary_tpu_torch.graph.device import import_graph as timport_graph
from vectorgraphlibrary_tpu_torch.models import cc as tcc
from vectorgraphlibrary_tpu_torch.utils.verify import equal_components

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPHS = ["small_rmat", "small_ru", "path"]
FLAGS = ["default", "-sv", "-bfs-based"]


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
            cache[name] = (ec, jimport_graph(ec), timport_graph(ec, device="cpu"),
                           tcc.seq_cc(ec))
        return cache[name]
    return get


def _check(got, want, tg, oracle):
    assert got.direction.name == want.direction.name == "ORIGINAL"
    assert got.values.dtype == torch.int32
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    assert equal_components(got.values.numpy()[:tg.v], oracle) == 0
    assert bool((got.values[tg.v:] == tg.v).all())          # padding


# variant -> kwargs of vgl_cc_hybrid; the path graph's bad hub sits mid-path
# and max_flood=2 cuts its flood short (the non-closure guard); without a
# flood the hook-min over everything needs more than 2 iterations
HYBRID = {
    "default-hub": {},
    "bad-hub": dict(hub=3),
    "flood-cut-short": dict(hub=30, max_flood=2),
    "iteration-cap": dict(max_flood=0, max_iterations=2),
}
# variants whose flood does not close: the port finishes by link rounds
# (models/cc._link_rounds), the JAX package by hook-min up to its cap, so
# their round counts differ; with "iteration-cap" the JAX package stops
# short of its fixpoint, the port reaches it within the same cap
LINKED = ("flood-cut-short", "iteration-cap")


def _least_ids(oracle):
    """Each vertex's label: the least vertex id of its component."""
    first = np.full(oracle.max() + 1, len(oracle))
    np.minimum.at(first, oracle, np.arange(len(oracle)))
    return first[oracle]


@pytest.mark.parametrize("graph", GRAPHS)
def test_shiloach_vishkin_matches_jax_and_oracle(graphs, graph):
    _, jg, tg, oracle = graphs(graph)
    got, iters = tcc.vgl_shiloach_vishkin(tg)
    want, jiters = jcc.vgl_shiloach_vishkin(jg)
    _check(got, want, tg, oracle)
    assert iters == jiters and isinstance(iters, int)
    if graph == "path":
        assert iters > 4        # the every-fourth-iteration jumps ran


@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("variant", list(HYBRID))
def test_cc_hybrid_matches_jax_and_oracle(graphs, graph, variant):
    _, jg, tg, oracle = graphs(graph)
    kw = HYBRID[variant]
    got, iters = tcc.vgl_cc_hybrid(tg, **kw)
    want, jiters = jcc.vgl_cc_hybrid(jg, **kw)
    if variant not in LINKED:
        assert iters == jiters
        _check(got, want, tg, oracle)
        return
    np.testing.assert_array_equal(got.values.numpy()[:tg.v],
                                  _least_ids(oracle))
    assert bool((got.values[tg.v:] == tg.v).all())          # padding
    if variant == "iteration-cap":
        assert jiters == 2 and 1 <= iters <= 2
    else:
        _check(got, want, tg, oracle)
        assert 1 <= iters < jiters


@pytest.mark.parametrize("graph", GRAPHS)
def test_cc_hybrid_multi_matches_jax_and_oracle(graphs, graph):
    _, jg, tg, oracle = graphs(graph)
    hubs = [0, 5, 11]
    got = tcc.vgl_cc_hybrid_multi(tg, hubs)
    want = jcc.vgl_cc_hybrid_multi(jg, hubs)
    assert got.values.shape == (3, tg.v_pad)
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    for i, h in enumerate(hubs):
        assert equal_components(got.values[i].numpy()[:tg.v], oracle) == 0
        assert torch.equal(got.values[i], tcc.vgl_cc_hybrid(tg, hub=h)[0].values)


@pytest.mark.parametrize("graph", ["small_ru", "path"])
def test_bfs_based_matches_jax_and_oracle(graphs, graph):
    """Equal as components, and here also label for label (both label a
    component by the first unlabeled vertex)."""
    _, jg, tg, oracle = graphs(graph)
    got = tcc.vgl_bfs_based(tg)
    want = jcc.vgl_bfs_based(jg)
    _check(got, want, tg, oracle)
    assert equal_components(got.values.numpy()[:tg.v],
                            np.asarray(want.values)[:tg.v]) == 0


def test_default_hub_is_the_first_max_outdegree_vertex(graphs):
    ec, _, tg, _ = graphs("small_rmat")
    outdeg = np.bincount(ec.src_ids, minlength=ec.vertices_count)
    hub = int(np.argmax(outdeg))
    assert torch.equal(tcc.vgl_cc_hybrid(tg)[0].values,
                       tcc.vgl_cc_hybrid(tg, hub=hub)[0].values)


@pytest.mark.parametrize("flag", FLAGS)
def test_app_cli_contract(flag):
    args = [] if flag == "default" else [flag]
    out = subprocess.run(
        [sys.executable, "-m", "vectorgraphlibrary_tpu_torch.apps.cc", "-s",
         "10", "-e", "8", "-it", "2", "-check", "-dev", "cpu", *args],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "AVG_PERF:" in out.stdout
    assert out.stdout.count("error count: 0") == 2
