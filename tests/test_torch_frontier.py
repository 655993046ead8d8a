"""PyTorch port, frontiers: Frontier construction, compact_ids and
generate_new_frontier against the JAX package on RMAT-10 and RU-9, exactly
(masks, counts and compacted ids are integers)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from vectorgraphlibrary_tpu.config import TraversalDirection as JDir
from vectorgraphlibrary_tpu.graph import frontier as jfrontier
from vectorgraphlibrary_tpu.graph.device import import_graph as jimport_graph
from vectorgraphlibrary_tpu.ops.frontier_ops import (
    generate_new_frontier as jgnf)

from vectorgraphlibrary_tpu_torch.config import Sparsity
from vectorgraphlibrary_tpu_torch.config import TraversalDirection as TDir
from vectorgraphlibrary_tpu_torch.graph import frontier as tfrontier
from vectorgraphlibrary_tpu_torch.graph.device import import_graph as timport_graph
from vectorgraphlibrary_tpu_torch.ops.frontier_ops import (
    generate_new_frontier as tgnf)

GRAPHS = ["small_rmat", "small_ru"]
DIRS = {"S": (JDir.SCATTER, TDir.SCATTER), "G": (JDir.GATHER, TDir.GATHER)}


@pytest.fixture(scope="module")
def graphs(request):
    cache = {}

    def get(name):
        if name not in cache:
            ec = request.getfixturevalue(name)
            cache[name] = (ec, jimport_graph(ec), timport_graph(ec, device="cpu"))
        return cache[name]
    return get


def _same_frontier(tf, jf):
    np.testing.assert_array_equal(tf.mask.numpy(), np.asarray(jf.mask))
    assert tf.size.dtype == torch.int32
    assert int(tf.size) == int(jf.size)
    assert int(tf.neighbours_count) == int(jf.neighbours_count)
    assert tf.direction.name == jf.direction.name
    assert tf.sparsity.name == jf.sparsity.name


def _mask(v_pad, p, seed):
    """Random mask over ALL v_pad slots: padding slots must be masked off."""
    return np.random.default_rng(seed).random(v_pad) < p


@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("d", list(DIRS))
def test_from_mask_and_all_active_match_jax(graphs, graph, d):
    _, jg, tg = graphs(graph)
    jd, td = DIRS[d]
    m = _mask(jg.v_pad, 0.3, 1)
    _same_frontier(tfrontier.from_mask(tg, torch.from_numpy(m), td),
                   jfrontier.from_mask(jg, jnp.asarray(m), jd))
    _same_frontier(tfrontier.all_active(tg, td), jfrontier.all_active(jg, jd))


@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("d", list(DIRS))
def test_from_vertex_matches_jax(graphs, graph, d):
    ec, jg, tg = graphs(graph)
    jd, td = DIRS[d]
    for vtx in (0, 7, ec.vertices_count - 1):
        _same_frontier(tfrontier.from_vertex(tg, vtx, td),
                       jfrontier.from_vertex(jg, vtx, jd))


# capacities against v_pad (1024 for RMAT-10, 512 for RU-9) and the active
# count: below (overflow: active ids beyond the capacity drop), at v_pad,
# above v_pad (padded with v_pad)
CAPS = {"overflow-64": 64, "below-256": 256, "at-v_pad": None,
        "above-2x": "2x"}


@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("cap", list(CAPS))
def test_compact_ids_matches_jax(graphs, graph, cap):
    _, jg, tg = graphs(graph)
    capacity = {None: jg.v_pad, "2x": 2 * jg.v_pad}.get(CAPS[cap], CAPS[cap])
    m = _mask(jg.v_pad, 0.2, 2)
    jf = jfrontier.from_mask(jg, jnp.asarray(m), JDir.SCATTER)
    tf = tfrontier.from_mask(tg, torch.from_numpy(m), TDir.SCATTER)
    jids, jvalid = jfrontier.compact_ids(jf, capacity)
    tids, tvalid = tfrontier.compact_ids(tf, capacity)
    assert tids.dtype == torch.int32 and tids.shape == (capacity,)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    if cap == "overflow-64":
        assert int(tf.size) > capacity and bool(tvalid.all())


@pytest.mark.parametrize("graph", GRAPHS)
def test_generate_new_frontier_matches_jax(graphs, graph):
    _, jg, tg = graphs(graph)
    x = np.random.default_rng(3).integers(0, 4, jg.v_pad).astype(np.int32)
    jf = jgnf(jg, lambda ids, degs, a: (a["x"] >= 2) & (degs > 1),
              {"x": jnp.asarray(x)}, direction=JDir.GATHER,
              classify_on_host=True)
    tf = tgnf(tg, lambda ids, degs, a: (a["x"] >= 2) & (degs > 1),
              {"x": torch.from_numpy(x)}, direction=TDir.GATHER,
              classify_on_host=True)
    _same_frontier(tf, jf)


@pytest.mark.parametrize("ratio,want", [(1.0, Sparsity.ALL_ACTIVE),
                                        (0.5, Sparsity.DENSE),
                                        (0.001, Sparsity.SPARSE)])
def test_classify_sparsity_matches_jax(ratio, want):
    assert tfrontier.classify_sparsity(ratio, 0.03) == want
    assert jfrontier.classify_sparsity(ratio, 0.03).name == want.name
