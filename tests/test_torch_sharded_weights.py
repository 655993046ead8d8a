"""PyTorch port, sharded persistence of distribution part 2 against the JAX
package: route-slot edge weights (save_sharded_weights,
load_sharded_weights) written by either package load in the other and lay
out, bit for bit, as each package lays out the same COO weights; a port
slim shard saves and loads, and its scans run bit-equal; a slim shard of
the JAX package (no CSR) loads with its CSRs rebuilt from the advance
route. RMAT-10 (average degree 8, seed 3, weighted) in 4 shards."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorgraphlibrary_tpu.graph import persistence as jpersistence
from vectorgraphlibrary_tpu.io import generation as jgen
from vectorgraphlibrary_tpu.parallel import shard_build as jsb

from vectorgraphlibrary_tpu_torch.graph import persistence
from vectorgraphlibrary_tpu_torch.io import generation
from vectorgraphlibrary_tpu_torch.parallel import shard_build as sb
from vectorgraphlibrary_tpu_torch.parallel import sharded

N_SHARDS = 4
GRAPH = dict(scale=10, avg_degree=8, seed=3, weighted=True)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    d = tmp_path_factory.mktemp("weights")
    ec = jgen.rmat(**GRAPH)
    hosts = []
    jsg = jsb.import_sharded(ec, N_SHARDS, _host_out=hosts)
    wst = jsb.shard_edge_values(ec.weights, jsg, ec, hosts)
    jprefix = str(d / "jax")
    jpersistence.save_sharded_graph(jsg, jprefix)
    jslot = np.asarray(wst.incoming.slot_flat)
    jpersistence.save_sharded_weights(list(jslot), jprefix)
    pec = generation.rmat(**GRAPH)
    phosts = []
    sg = sb.import_sharded(pec, N_SHARDS, device="cpu", _host_out=phosts)
    pw = sb.shard_edge_values(pec.weights, sg, pec, phosts)
    return dict(d=d, ec=pec, jsg=jsg, jprefix=jprefix, jslot=jslot, sg=sg,
                weights=pw)


def test_jax_weights_load_in_the_port(built):
    """Through the shards of the JAX package's files, whose in_route_slots
    the loader derives from the CSR and the tiles' metadata."""
    loaded = persistence.load_sharded_graph(built["jprefix"], device="cpu")
    for s in range(N_SHARDS):
        assert torch.equal(loaded.shard(s).in_route_slots,
                           built["sg"].shard(s).in_route_slots)
    ws = sharded.slot_weights_stacked(persistence.load_sharded_weights(
        built["jprefix"], N_SHARDS, device="cpu"), loaded)
    for s in range(N_SHARDS):
        e = loaded.shard(s).incoming.e
        got = ws[s].incoming.flat[:e].numpy()
        want = built["weights"][s].incoming.flat[:e].numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


def test_port_weights_load_in_jax(built):
    prefix = str(built["d"] / "port")
    persistence.save_sharded_weights(
        sharded.route_slot_weights(built["sg"], built["weights"]), prefix)
    got = np.asarray(jpersistence.load_sharded_weights(prefix, N_SHARDS))
    np.testing.assert_array_equal(got.view(np.uint32),
                                  built["jslot"].view(np.uint32))


@pytest.mark.parametrize("partial", [True, False])
def test_stored_weights_run_as_the_built_ones(built, partial):
    sg = built["sg"]
    ws = sharded.slot_weights_stacked(persistence.load_sharded_weights(
        built["jprefix"], N_SHARDS, device="cpu"), sg)
    src = 5
    got, it = sharded.sssp_sharded_scan(sg, ws, src, partial=partial)
    want, want_it = sharded.sssp_sharded_scan(sg, built["weights"], src,
                                              partial=partial)
    assert torch.equal(got, want) and it == want_it


def test_port_slim_shards_save_load_and_run_bit_equal(built):
    ec = built["ec"]
    slim = sb.import_sharded(ec, N_SHARDS, device="cpu", slim=True)
    prefix = str(built["d"] / "slim")
    persistence.save_sharded_graph(slim, prefix)
    with np.load(f"{prefix}.shard0.npz") as z:
        assert "route.meta" not in z.files and "in.col_idx" in z.files
        assert not any(k.endswith(".adj") or "sorted" in k for k in z.files)
    loaded = persistence.load_sharded_graph(prefix, device="cpu")
    for a, b in zip(loaded.shards, slim.shards):
        assert a.slim and a.advance_route is None
        for f in ("outgoing", "incoming"):
            x, y = getattr(a, f), getattr(b, f)
            for k in ("row_ptr", "col_idx", "degrees"):
                assert torch.equal(getattr(x, k), getattr(y, k)), (f, k)
        assert torch.equal(a.in_route_slots, b.in_route_slots)
    for fn in (lambda g: sharded.pagerank_sharded_scan(g, ec, 10),
               lambda g: sharded.bfs_sharded_scan(g, 5),
               lambda g: sharded.sssp_sharded_scan_hash(g, 5)[0]):
        assert torch.equal(fn(loaded), fn(slim))


def test_jax_slim_shard_loads(built):
    """The JAX package's slim shards (the advance route kept, the CSRs
    dropped) load with their CSRs rebuilt from the route: equal to the
    port's slim import of the same graph, and the JAX package's route-slot
    weights lay out on them as on the port's full shards."""
    ec = jgen.rmat(**GRAPH)
    jslim = jsb.import_sharded(ec, N_SHARDS, slim=True)
    prefix = str(built["d"] / "jslim")
    jpersistence.save_sharded_graph(jslim, prefix)
    with np.load(f"{prefix}.shard0.npz") as z:
        assert "route.meta" in z.files and "in.col_idx" not in z.files
    one = persistence.load_graph_from_binary_file(f"{prefix}.shard0.npz",
                                                  device="cpu")
    loaded = persistence.load_sharded_graph(prefix, device="cpu")
    want = sb.import_sharded(built["ec"], N_SHARDS, device="cpu", slim=True)
    for a, b in zip((one, *loaded.shards), (want.shard(0), *want.shards)):
        assert a.slim and a.advance_route is None
        for f in ("outgoing", "incoming"):
            x, y = getattr(a, f), getattr(b, f)
            for k in ("row_ptr", "col_idx", "degrees"):
                assert torch.equal(getattr(x, k), getattr(y, k)), (f, k)
        assert torch.equal(a.in_route_slots, b.in_route_slots)
    ws = sharded.slot_weights_stacked(persistence.load_sharded_weights(
        built["jprefix"], N_SHARDS, device="cpu"), loaded)
    for s in range(N_SHARDS):
        e = loaded.shard(s).incoming.e
        assert torch.equal(ws[s].incoming.flat[:e],
                           built["weights"][s].incoming.flat[:e])
