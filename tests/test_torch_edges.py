"""PyTorch port, edge values: EdgeArray against the JAX package's on RMAT-10,
RU-9 and a path graph (the flat CSR-order copy of both directions, equal),
built from either package's host CSRs; prepare_graph's weights; and the
fast oracles of SSWP and HITS against the JAX package's literal ones."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorgraphlibrary_tpu.config import VGLConfig as JConfig
from vectorgraphlibrary_tpu.graph.device import import_graph as jimport_graph
from vectorgraphlibrary_tpu.graph.edges import (
    build_edge_array_from_host as jbuild_edge_array)
from vectorgraphlibrary_tpu.io.edges_container import EdgesContainer
from vectorgraphlibrary_tpu.models import cc as jcc
from vectorgraphlibrary_tpu.models import hits as jhits
from vectorgraphlibrary_tpu.models import sssp as jsssp
from vectorgraphlibrary_tpu.models import sswp as jsswp
from vectorgraphlibrary_tpu.runtime import runtime as jruntime

from vectorgraphlibrary_tpu_torch.config import TraversalDirection as TDir
from vectorgraphlibrary_tpu_torch.config import VGLConfig as TConfig
from vectorgraphlibrary_tpu_torch.graph.device import import_graph as timport_graph
from vectorgraphlibrary_tpu_torch.graph.edges import (
    build_edge_array_from_host as tbuild_edge_array, edge_array_from_flat)
from vectorgraphlibrary_tpu_torch.models import cc as tcc
from vectorgraphlibrary_tpu_torch.models import common as tcommon
from vectorgraphlibrary_tpu_torch.models import hits as thits
from vectorgraphlibrary_tpu_torch.models import sssp as tsssp
from vectorgraphlibrary_tpu_torch.models import sswp as tsswp
from vectorgraphlibrary_tpu_torch.runtime import runtime as truntime

GRAPHS = ["small_rmat", "small_ru", "path"]


def _path_graph():
    """tests/test_algorithms.py's path of 60 vertices plus a triangle."""
    n = 60
    src = np.concatenate([np.arange(n - 1), [n, n + 1, n + 2]]).astype(np.int32)
    dst = np.concatenate([np.arange(1, n), [n + 1, n + 2, n]]).astype(np.int32)
    return EdgesContainer(src, dst, n + 3)


@pytest.fixture(scope="module")
def graphs(request):
    """name -> (ec, JAX graph, JAX EdgeArray, JAX host CSRs, port graph,
    port EdgeArray, port host CSRs), built once."""
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
            cache[name] = (ec, jg, jea, jhost, tg, tea, thost)
        return cache[name]
    return get


@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("d", ["outgoing", "incoming"])
def test_edge_array_flat_equals_jax(graphs, graph, d):
    ec, jg, jea, jhost, tg, tea, _ = graphs(graph)
    want = np.asarray(getattr(jea, d).flat)
    got = getattr(tea, d).flat
    assert got.dtype == torch.float32 and got.shape == (getattr(tg, d).e_pad,)
    np.testing.assert_array_equal(got.numpy(), want)
    # the JAX package's host CSRs carry the weights across too
    tea2 = tbuild_edge_array(ec.weights, tg, jhost[0], jhost[1])
    np.testing.assert_array_equal(getattr(tea2, d).flat.numpy(), want)
    # slot k of row r holds the weight of an edge col_idx[k] -> r (or r ->
    # col_idx[k]) of the COO list
    dg = getattr(tg, d)
    assert float(got[dg.e:].abs().sum()) == 0.0           # padding
    assert sorted(got[:dg.e].tolist()) == sorted(ec.weights.tolist())


def test_edge_array_directions_and_dtypes(graphs):
    ec, _, _, _, tg, tea, thost = graphs("small_ru")
    assert tea.direction(TDir.SCATTER) is tea.outgoing
    assert tea.direction(TDir.GATHER) is tea.incoming
    ints = np.arange(ec.edges_count, dtype=np.int32)
    ea = tbuild_edge_array(ints, tg, thost[0], thost[1], pad_value=-1)
    assert ea.outgoing.flat.dtype == torch.int32
    e = tg.outgoing.e
    np.testing.assert_array_equal(ea.outgoing.flat[:e].numpy(),
                                  thost[0].edge_perm[:e])
    assert bool((ea.incoming.flat[tg.incoming.e:] == -1).all())
    again = edge_array_from_flat(tg, ea.outgoing.flat, ea.incoming.flat)
    assert again.outgoing.flat is ea.outgoing.flat
    with pytest.raises(ValueError):
        edge_array_from_flat(tg, ea.outgoing.flat[:-1], ea.incoming.flat)
    other = graphs("path")
    with pytest.raises(ValueError):
        tbuild_edge_array(ec.weights, tg, other[6][0], other[6][1])


@pytest.mark.parametrize("kind", ["rmat", "ru"])
def test_prepare_graph_weights_match_jax(kind):
    """Synthetic graphs get the JAX package's random weights (seed + 1)."""
    kw = dict(scale=8, avg_degree=4, seed=5)
    if kind == "ru":
        from vectorgraphlibrary_tpu.config import SyntheticGraphType as JT
        from vectorgraphlibrary_tpu_torch.config import SyntheticGraphType as TT
        jcfg = JConfig(synthetic_type=JT.RANDOM_UNIFORM, **kw)
        tcfg = TConfig(synthetic_type=TT.RANDOM_UNIFORM, **kw)
    else:
        jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    jec, _, jea = jruntime.prepare_graph(jcfg, need_weights=True)
    tec, tg, tea = truntime.prepare_graph(tcfg, need_weights=True,
                                          device="cpu")
    np.testing.assert_array_equal(tec.weights, jec.weights)
    for d in ("outgoing", "incoming"):
        np.testing.assert_array_equal(getattr(tea, d).flat.numpy(),
                                      np.asarray(getattr(jea, d).flat))
    assert truntime.prepare_graph(tcfg, device="cpu")[2] is None


@pytest.mark.parametrize("graph", GRAPHS)
def test_oracles_match_jax(graphs, graph):
    """The port's oracles against the JAX package's on the same edges: the
    copies exactly, and the fast widest-paths and HITS oracles against the
    JAX package's literal ones exactly too (a max has one answer in any
    order, and bincount adds in np.add.at's order)."""
    ec = graphs(graph)[0]
    np.testing.assert_array_equal(tcc.seq_cc(ec), jcc.seq_cc(ec))
    for seed in range(2):
        src = tcommon.select_random_source(ec, seed=seed)
        np.testing.assert_array_equal(tsssp.seq_dijkstra(ec, src),
                                      jsssp.seq_dijkstra(ec, src))
        want = jsswp.seq_widest_paths(ec, src)
        np.testing.assert_array_equal(tsswp.seq_widest_paths(ec, src), want)
    for got, want in zip(thits.seq_hits(ec, iterations=5),
                         jhits.seq_hits(ec, iterations=5)):
        np.testing.assert_array_equal(got, want)
