"""PyTorch port, the rank drivers of distribution part 2
(make_coloring_sharded, make_sssp_sharded_partial, make_bfs_do_sharded,
make_msbfs_sharded, make_cc_hybrid_sharded) on 2 and 4 gloo ranks on the
CPU (parallel/launch.run_ranks; the rank function is
tests/torch_rank_cases.ranks2_rank, which imports no JAX), each rank
building only its own shard of the JAX package's sharded fixture (RMAT-10,
average degree 8, seed 3, weighted). Every result equals, exactly, the JAX
package's make_*_sharded on 2 devices of its virtual CPU mesh (the results
do not depend on the shard count; 2 devices keep its collectives cheap
under a loaded CPU) and the port's own one-card twins (the scans, in 2
shards, and the unsharded vgl_bfs_device's levels for DO-BFS); the
coloring is valid. The coloring's banned-color words merge as
a bitwise or: the case's SCATTER words differ by rank, and an unsigned max
of them loses bits."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from vectorgraphlibrary_tpu.io import generation as jgen
from vectorgraphlibrary_tpu.models import common
from vectorgraphlibrary_tpu.parallel import shard_build as jsb
from vectorgraphlibrary_tpu.parallel import sharded as jsh
from vectorgraphlibrary_tpu.parallel.mesh import make_mesh as jmake_mesh

from vectorgraphlibrary_tpu_torch.graph.device import import_graph
from vectorgraphlibrary_tpu_torch.graph.vertices import as_original_numpy
from vectorgraphlibrary_tpu_torch.io import generation
from vectorgraphlibrary_tpu_torch.models import bfs as bfsm, common as tcommon
from vectorgraphlibrary_tpu_torch.parallel import shard_build as sb
from vectorgraphlibrary_tpu_torch.parallel import sharded
from vectorgraphlibrary_tpu_torch.parallel.launch import run_ranks

GRAPH = dict(scale=10, degree=8, seed=3)
WORDS = 1


@pytest.fixture(scope="module")
def case():
    ec = jgen.rmat(scale=10, avg_degree=8, seed=3, weighted=True)
    source = common.select_random_source(ec, seed=13)
    hub = int(np.argmax(np.bincount(ec.src_ids, minlength=ec.vertices_count)))
    rng = np.random.default_rng(11)
    roots = [common.select_random_source(ec, seed=int(s))
             for s in rng.integers(0, 1000, 32)]
    hosts = []
    jsg = jsb.import_sharded(ec, 2, _host_out=hosts)
    wst = jsb.shard_edge_values(ec.weights, jsg, ec, hosts)
    mesh = jmake_mesh(2, 1, jax.devices()[:2])
    labels, fl, hk = jsh.make_cc_hybrid_sharded(jsg, mesh)(jsg.stacked,
                                                           jnp.int32(hub))
    jax_out = dict(
        coloring=np.asarray(jsh.make_coloring_sharded(
            jsg, mesh, words=WORDS)(jsg.stacked)),
        sssp_partial=np.asarray(jsh.make_sssp_sharded_partial(
            jsg, mesh, wst, delta_capacity=256)(jsg.stacked, wst,
                                                jnp.int32(source))),
        bfs_do=np.asarray(jsh.make_bfs_do_sharded(
            jsg, mesh, id_cap=1 << 8, edge_cap=1 << 12)(jsg.stacked,
                                                        jnp.int32(source))),
        msbfs=np.asarray(jsh.make_msbfs_sharded(jsg, mesh)(
            jsg.stacked, jnp.asarray(np.asarray(roots, np.int32)))),
        cc_hybrid=np.asarray(labels),
        cc_hybrid_counts=np.asarray([int(fl), int(hk)]))
    # the port's one-card twins
    pec = generation.rmat(scale=10, avg_degree=8, seed=3, weighted=True)
    phosts = []
    psg = sb.import_sharded(pec, 2, device="cpu", _host_out=phosts)
    pw = sb.shard_edge_values(pec.weights, psg, pec, phosts)
    labels, fl, hk = sharded.cc_hybrid_sharded_scan(psg, hub)
    g = import_graph(pec, device="cpu")
    twins = dict(
        coloring=sharded.coloring_sharded_scan(psg, words=WORDS).numpy(),
        sssp_partial=sharded.sssp_sharded_scan(psg, pw, source)[0].numpy(),
        msbfs=sharded.msbfs_sharded_scan(psg, roots).numpy(),
        cc_hybrid=labels.numpy(), cc_hybrid_counts=np.asarray([fl, hk]))
    twins["bfs_do"] = np.full(g.v_pad, -1, np.int32)
    twins["bfs_do"][:g.v] = as_original_numpy(
        bfsm.vgl_bfs_device(g, source, id_cap=1 << 8, edge_cap=1 << 12), g)
    ids = np.arange(g.v_pad)
    word = torch.from_numpy(np.where(ids < g.v, np.left_shift(
        np.int64(1), ids % 32), 0).astype(np.uint32).view(np.int32))
    twins["word"] = tcommon.undirected_value_pull(g, word, "or").numpy()
    kwargs = dict(source=source, hub=hub, roots=roots, words=WORDS, **GRAPH)
    return ec, jax_out, twins, kwargs


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, case):
    return run_ranks("tests.torch_rank_cases:ranks2_rank", request.param,
                     device="cpu", kwargs=case[3], timeout=300)


@pytest.mark.parametrize("name", ["coloring", "sssp_partial", "bfs_do",
                                  "msbfs", "cc_hybrid"])
def test_rank_drivers_equal_jax_and_the_one_card_twins(case, ranks, name):
    _, jax_out, twins, _ = case
    for r in ranks:
        np.testing.assert_array_equal(r[name], jax_out[name], err_msg=name)
        np.testing.assert_array_equal(r[name], twins[name], err_msg=name)
        if name == "cc_hybrid":
            np.testing.assert_array_equal(r["cc_hybrid_counts"],
                                          jax_out["cc_hybrid_counts"])
            np.testing.assert_array_equal(r["cc_hybrid_counts"],
                                          twins["cc_hybrid_counts"])


def test_coloring_is_valid(case, ranks):
    ec = case[0]
    colors = ranks[0]["coloring"][:ec.vertices_count]
    nonloop = ec.src_ids != ec.dst_ids
    assert (colors >= 0).all()
    assert (colors[ec.src_ids[nonloop]] != colors[ec.dst_ids[nonloop]]).all()


def test_banned_words_merge_as_or_not_max(case, ranks):
    """Every rank's or-merge equals the unsharded undirected pull; the
    unsigned max of the same words differs from it."""
    twins = case[2]
    for r in ranks:
        np.testing.assert_array_equal(r["word_or"], twins["word"])
        assert (r["word_max"] != twins["word"]).any()
