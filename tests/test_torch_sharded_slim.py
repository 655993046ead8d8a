"""PyTorch port, slim shards and edge weights by route slot, against the
JAX package on its slim fixture (RMAT-10, average degree 8, seed 5, 2
shards; tests/test_sharded.py:118-121), Pallas in interpret mode.

The port's slim shard keeps each direction's CSR and drops the advance
route and the tiles (shard_build.slim_value_pull says why that is the
reverse of the JAX package's). Its scans equal the JAX package's slim scans:
PageRank within rtol 1e-5, HITS within rtol 1e-5 and atol 1e-6 of the
maximum, BFS and MS-BFS levels and CC labels exactly. The slot-hash weights
equal the JAX package's bit for bit on every edge, and the SSSP over them
(partial and all-active) equals its distances and sweep counts exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from vectorgraphlibrary_tpu.graph.route_build import slot_map
from vectorgraphlibrary_tpu.io import generation as jgen
from vectorgraphlibrary_tpu.models import common
from vectorgraphlibrary_tpu.parallel import shard_build as jsb
from vectorgraphlibrary_tpu.parallel import sharded as jsh

from vectorgraphlibrary_tpu_torch.io import generation
from vectorgraphlibrary_tpu_torch.parallel import shard_build as sb
from vectorgraphlibrary_tpu_torch.parallel import sharded

N_SHARDS = 2
PR_ITERS, HITS_ITERS = 25, 10
GRAPH = dict(scale=10, avg_degree=8, seed=5)


def _roots(ec):
    rng = np.random.default_rng(9)
    return np.array([common.select_random_source(ec, seed=int(s))
                     for s in rng.integers(0, 1000, 32)], np.int32)


def _hub(ec):
    return int(np.argmax(np.bincount(ec.src_ids, minlength=ec.vertices_count)))


@pytest.fixture(scope="module")
def jax_slim():
    ec = jgen.rmat(weighted=False, **GRAPH)
    jsg = jsb.import_sharded(ec, N_SHARDS, slim=True)
    return ec, jsg


@pytest.fixture(scope="module")
def port():
    ec = generation.rmat(weighted=False, **GRAPH)
    hosts = []
    full = sb.import_sharded(ec, N_SHARDS, device="cpu", _host_out=hosts)
    slim = sb.import_sharded(ec, N_SHARDS, device="cpu", slim=True)
    return ec, full, slim, hosts


def test_slim_shard_holds_no_route_and_no_tiles(port):
    _, full, slim, _ = port
    for g, f in zip(slim.shards, full.shards):
        assert g.slim and not f.slim
        assert g.advance_route is None and f.advance_route is not None
        for dg in (g.outgoing, g.incoming):
            assert all(b.adj is None for b in dg.buckets)
            assert dg.huge is None or dg.huge.adj is None
            assert dg.sorted_to_orig is None and dg.orig_to_sorted is None
            assert dg.row_ptr is not None and dg.col_idx is not None
        assert torch.equal(g.in_route_slots, f.in_route_slots)
        assert (g.out_slots, g.in_slots) == (f.out_slots, f.in_slots)


def _nbytes(obj):
    import dataclasses
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if dataclasses.is_dataclass(obj):
        return sum(_nbytes(getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    if isinstance(obj, (tuple, list)):
        return sum(_nbytes(x) for x in obj)
    return 0


def test_slim_shards_take_fewer_bytes(port):
    _, full, slim, _ = port
    a, b = _nbytes(full.shards), _nbytes(slim.shards)
    print(f"RMAT-10 in {N_SHARDS} shards: full {a / 2**20:.3f} MiB, slim "
          f"{b / 2**20:.3f} MiB")
    assert b < a


def _scan(name, sg, ec, roots, hub):
    if name == "pagerank":
        return sharded.pagerank_sharded_scan(sg, ec, PR_ITERS).numpy()
    if name == "hits":
        return [t.numpy() for t in sharded.hits_sharded_scan(sg, HITS_ITERS)]
    if name == "bfs":
        return sharded.bfs_sharded_scan(sg, int(roots[0])).numpy()
    if name == "cc":
        labels, it = sharded.cc_sharded_scan(sg)
        return labels.numpy(), it
    if name == "msbfs":
        return sharded.msbfs_sharded_scan(sg, roots).numpy()
    labels, fl, hk = sharded.cc_hybrid_sharded_scan(sg, hub)
    return labels.numpy(), fl, hk


def _jax_scan(name, jsg, ec, roots, hub):
    if name == "pagerank":
        return np.asarray(jsh.pagerank_sharded_scan(jsg, ec, PR_ITERS))
    if name == "hits":
        return [np.asarray(t) for t in jsh.hits_sharded_scan(jsg, HITS_ITERS)]
    if name == "bfs":
        return np.asarray(jsh.bfs_sharded_scan(jsg, jnp.int32(roots[0])))
    if name == "cc":
        labels, it = jsh.cc_sharded_scan(jsg)
        return np.asarray(labels), int(it)
    if name == "msbfs":
        return np.asarray(jsh.msbfs_sharded_scan(jsg, jnp.asarray(roots)))
    labels, fl, hk = jsh.cc_hybrid_sharded_scan(jsg, jnp.int32(hub))
    return np.asarray(labels), int(fl), int(hk)


def _hold(name, got, want):
    if name == "pagerank":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)
    elif name == "hits":
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-5,
                                       atol=1e-6 * float(np.abs(w).max()))
    elif name in ("cc", "cc_hybrid"):
        np.testing.assert_array_equal(got[0], want[0])
        assert tuple(got[1:]) == tuple(want[1:])
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["pagerank", "hits", "bfs", "cc", "msbfs",
                                  "cc_hybrid"])
def test_slim_scans_equal_the_jax_slim_scans(jax_slim, port, name):
    jec, jsg = jax_slim
    ec, full, slim, _ = port
    roots, hub = _roots(ec), _hub(ec)
    got = _scan(name, slim, ec, roots, hub)
    _hold(name, got, _jax_scan(name, jsg, jec, roots, hub))
    # and the port's full shards, bit for bit
    want = _scan(name, full, ec, roots, hub)
    for g, w in zip(got if isinstance(got, (list, tuple)) else [got],
                    want if isinstance(want, (list, tuple)) else [want]):
        np.testing.assert_array_equal(g, w)


def test_hash_weights_equal_the_jax_package_bit_for_bit(jax_slim, port):
    """On every route slot, and on every edge through slot_map. The JAX
    package's weights as its compiled scans compute them (under jax.jit,
    where XLA fuses lo + (hi - lo) * u into one multiply-add)."""
    _, jsg = jax_slim
    _, full, slim, hosts = port
    n = jsg.stacked.advance_route.n
    assert sharded.route_slot_count(slim.shard(0)) == n
    jfn = jsh.slot_hash_weight_fn(n)
    jweights = jax.jit(lambda s: jfn(s).slot_flat)
    fn = sharded.slot_hash_weight_fn(n)
    for s in range(N_SHARDS):
        want = np.asarray(jweights(jnp.int32(s)))
        got_all = sharded.slot_hash_weights(torch.arange(n), s).numpy()
        np.testing.assert_array_equal(got_all.view(np.uint32),
                                      want.view(np.uint32))
        h_in = hosts[s][1]
        e = h_in.edges_count
        m, _ = slot_map(h_in)
        got = fn(s, slim.shard(s)).flat[:e].numpy()
        np.testing.assert_array_equal(
            got.view(np.uint32), want[m[h_in.edge_perm[:e]]].view(np.uint32))


@pytest.mark.parametrize("partial", [True, False])
def test_sssp_scan_hash(jax_slim, port, partial):
    _, jsg = jax_slim
    ec, full, slim, _ = port
    src = common.select_random_source(ec, seed=4)
    wd, wit = jsh.sssp_sharded_scan_hash(jsg, jnp.int32(src), partial)
    for sg in (slim, full):
        dist, it = sharded.sssp_sharded_scan_hash(sg, src, partial)
        np.testing.assert_array_equal(dist.numpy(), np.asarray(wd))
        assert it == int(wit)


@pytest.mark.parametrize("which", ["full", "slim"])
def test_slot_weights_fit_each_shards_col_idx(port, which):
    """Both weight layouts (hashed, and stored through slot_weights_stacked)
    come padded to the incoming col_idx's length, which runs to e_pad on a
    full shard and ends at e on a slim one. A weight array of any other
    length is refused by the pull, not cut."""
    from vectorgraphlibrary_tpu_torch.graph.edges import DirectedEdgeValues
    _, full, slim, _ = port
    sg = full if which == "full" else slim
    n = sharded.route_slot_count(sg.shard(0))
    fn = sharded.slot_hash_weight_fn(n)
    stacked = sharded.slot_weights_stacked(
        [sharded.slot_hash_weights(torch.arange(n), s)
         for s in range(N_SHARDS)], sg)
    x = torch.zeros(sg.v_pad, dtype=torch.float32)
    for s, g in enumerate(sg.shards):
        hashed = fn(s, g).flat
        assert hashed.numel() == g.incoming.col_idx.numel()
        assert torch.equal(stacked[s].incoming.flat, hashed)
        with pytest.raises(ValueError, match="weights"):
            sharded._shard_pull_original(
                g, x, "min", edge_values=DirectedEdgeValues(flat=hashed[:-1]),
                weight_op="add")
