"""PyTorch port, the one-card scan twins of distribution part 2
(msbfs_sharded_scan and cc_hybrid_sharded_scan) against the JAX package on
its sharded fixture (RMAT-10, average degree 8, seed 3, weighted, 8
shards), Pallas in interpret mode: MS-BFS levels, CC labels, flood levels
and hook iterations exactly (coloring_sharded_scan is held to the JAX
package's make_coloring_sharded in test_torch_sharded_ranks2.py). The CC
cases include the JAX package's bad hub (vertex 17,
tests/test_sharded.py:181) and a flood capped below its depth, whose
component the non-closure guard must not freeze."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from vectorgraphlibrary_tpu.io import generation as jgen
from vectorgraphlibrary_tpu.models import common
from vectorgraphlibrary_tpu.parallel import shard_build as jsb
from vectorgraphlibrary_tpu.parallel import sharded as jsh

from vectorgraphlibrary_tpu_torch.graph.device import import_graph
from vectorgraphlibrary_tpu_torch.graph.vertices import as_original_numpy
from vectorgraphlibrary_tpu_torch.io import generation
from vectorgraphlibrary_tpu_torch.models import bfs as bfsm, cc as ccm
from vectorgraphlibrary_tpu_torch.parallel import shard_build as sb
from vectorgraphlibrary_tpu_torch.parallel import sharded
from vectorgraphlibrary_tpu_torch.utils import verify

N_SHARDS = 8
GRAPH = dict(scale=10, avg_degree=8, seed=3, weighted=True)


@pytest.fixture(scope="module")
def fixture():
    jec = jgen.rmat(**GRAPH)
    jsg = jsb.import_sharded(jec, N_SHARDS)
    ec = generation.rmat(**GRAPH)
    sg = sb.import_sharded(ec, N_SHARDS, device="cpu")
    rng = np.random.default_rng(11)
    roots = np.array([common.select_random_source(ec, seed=int(s))
                      for s in rng.integers(0, 1000, 32)], np.int32)
    return jec, jsg, ec, sg, roots


def test_msbfs_scan(fixture):
    jec, jsg, ec, sg, roots = fixture
    got = sharded.msbfs_sharded_scan(sg, roots)
    assert got.dtype == torch.int8 and got.shape == (32, sg.v_pad)
    want = np.asarray(jsh.msbfs_sharded_scan(jsg, jnp.asarray(roots)))
    np.testing.assert_array_equal(got.numpy(), want)
    # and the unsharded port's MS-BFS, root by root
    g = import_graph(ec, device="cpu")
    lv = bfsm.vgl_msbfs(g, roots)
    for r in (0, 15, 31):
        np.testing.assert_array_equal(
            got[r, :sg.v].numpy().astype(np.int32),
            as_original_numpy(type(lv)(values=lv.values[r],
                                       direction=lv.direction), g))


def _hubs(ec):
    return [int(np.argmax(np.bincount(ec.src_ids,
                                      minlength=ec.vertices_count))), 17]


@pytest.mark.parametrize("case", ["max_degree_hub", "bad_hub",
                                  "capped_flood"])
def test_cc_hybrid_scan(fixture, case):
    jec, jsg, ec, sg, _ = fixture
    hub = _hubs(ec)[case == "bad_hub"]
    kw = dict(max_flood_levels=2) if case == "capped_flood" else {}
    labels, fl, hk = sharded.cc_hybrid_sharded_scan(sg, hub, **kw)
    jl, jfl, jhk = jsh.cc_hybrid_sharded_scan(
        jsg, jnp.int32(hub), *((2,) if kw else ()))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    assert (fl, hk) == (int(jfl), int(jhk))
    assert verify.equal_components(labels[:sg.v].numpy(),
                                   ccm.seq_cc(ec)) == 0
    if case == "capped_flood":
        # the flood stopped with a live frontier: the hub's label spread
        # by hooks alone, after more iterations than the closed flood's
        _, _, hk_closed = sharded.cc_hybrid_sharded_scan(sg, hub)
        assert fl == 2 and hk > hk_closed
