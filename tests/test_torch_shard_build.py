"""PyTorch port, the sharded container: import_sharded on the JAX package's
sharded fixture (RMAT-10, average degree 8, seed 3, weighted, 8 shards)
gives the JAX package's paddings, per-shard edge counts, per-shard CSRs and
renumber maps, and the unified tile layout on every shard; import_shard
builds the same shard alone; shard_edge_values lays each shard's weights
out in its CSR slot order; estimated_shard_slots equals the reference's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorgraphlibrary_tpu.io import generation as jgen
from vectorgraphlibrary_tpu.parallel import shard_build as jsb

from vectorgraphlibrary_tpu_torch.config import GraphFormat
from vectorgraphlibrary_tpu_torch.io import generation
from vectorgraphlibrary_tpu_torch.parallel import shard_build as sb

N_SHARDS = 8
CSR_FIELDS = ("row_ptr", "col_idx", "degrees", "sorted_to_orig",
              "orig_to_sorted")


@pytest.fixture(scope="module")
def graphs():
    ec = generation.rmat(scale=10, avg_degree=8, seed=3, weighted=True)
    jec = jgen.rmat(scale=10, avg_degree=8, seed=3, weighted=True)
    assert np.array_equal(ec.src_ids, jec.src_ids)
    hosts = []
    sg = sb.import_sharded(ec, N_SHARDS, device="cpu", _host_out=hosts)
    jsg = jsb.import_sharded(jec, N_SHARDS)
    return ec, sg, hosts, jsg


def test_paddings_and_edge_counts(graphs):
    ec, sg, _, jsg = graphs
    assert (sg.n_shards, sg.v, sg.v_pad, sg.e) == (
        jsg.n_shards, jsg.v, jsg.v_pad, jsg.e)
    assert list(sg.edges_per_shard) == np.asarray(jsg.edges_per_shard).tolist()
    assert sum(sg.edges_per_shard) == ec.edges_count
    jg0 = jsg.shard(0)
    for g in sg.shards:
        assert (g.v, g.v_pad, g.e) == (jg0.v, jg0.v_pad, jg0.e)   # e = e_pad
        assert g.outgoing.e_pad == jg0.outgoing.e_pad
        assert g.graph_format == GraphFormat.SHARDED_CSR
        assert g.graph_format.value == jg0.graph_format.value
        assert g.advance_route.flags_fwd is not None


@pytest.mark.parametrize("s", range(N_SHARDS))
def test_shard_csr_equals_reference(graphs, s):
    _, sg, _, jsg = graphs
    g, jg = sg.shard(s), jsg.shard(s)
    for d in ("outgoing", "incoming"):
        dg, jdg = getattr(g, d), getattr(jg, d)
        # the reference's e is e_pad (its shards stack only with one
        # count); the port's is the CSR's own count
        assert (dg.v, dg.v_pad, dg.e_pad) == (jdg.v, jdg.v_pad, jdg.e_pad)
        assert jdg.e == jdg.e_pad
        assert dg.e == int(jdg.row_ptr[-1]) == sg.edges_per_shard[s]
        for f in CSR_FIELDS:
            np.testing.assert_array_equal(getattr(dg, f).numpy(),
                                          np.asarray(getattr(jdg, f)),
                                          err_msg=f"{d}.{f}")


@pytest.mark.parametrize("direction", ["outgoing", "incoming"])
def test_every_shard_has_the_unified_layout(graphs, direction):
    """The stacked reference holds one layout for all shards; each port
    shard has it: the same buckets (width, start, rows) and huge tile, and
    the same tile contents in the same slot order."""
    _, sg, _, jsg = graphs
    jstack = getattr(jsg.stacked, direction)
    layout = [(b.width, b.row_start, b.rows, b.rows_pad)
              for b in jstack.buckets]
    for s, g in enumerate(sg.shards):
        dg = getattr(g, direction)
        jdg = getattr(jsg.shard(s), direction)
        assert [(b.width, b.row_start, b.rows, b.rows_pad)
                for b in dg.buckets] == layout
        for b, jb in zip(dg.buckets, jdg.buckets):
            np.testing.assert_array_equal(b.adj.numpy().ravel(),
                                          np.asarray(jb.adj).ravel())
        assert (dg.huge is None) == (jstack.huge is None)
        if dg.huge is not None:
            h, jh = dg.huge, jdg.huge
            assert (h.chunk_w, h.n_rows, h.n_chunks, h.n_chunks_pad) == (
                jh.chunk_w, jh.n_rows, jh.n_chunks, jh.n_chunks_pad)
            np.testing.assert_array_equal(h.adj.numpy(), np.asarray(jh.adj))
            np.testing.assert_array_equal(h.seg_ids.numpy(),
                                          np.asarray(jh.seg_ids))


@pytest.mark.parametrize("s", [0, N_SHARDS - 1])
def test_import_shard_builds_one_shard_alone(graphs, s):
    ec, sg, hosts, _ = graphs
    own = []
    g = sb.import_shard(ec, N_SHARDS, s, device="cpu", _host_out=own)
    want = sg.shard(s)
    for d in ("outgoing", "incoming"):
        for f in CSR_FIELDS:
            assert torch.equal(getattr(getattr(g, d), f),
                               getattr(getattr(want, d), f))
    for attr in ("vertex_route_s_from_g", "vertex_route_s_from_o",
                 "vertex_route_g_from_o", "advance_route"):
        assert torch.equal(getattr(g, attr).fwd_idx,
                           getattr(want, attr).fwd_idx), attr
    assert np.array_equal(own[0][1].edge_perm, hosts[s][1].edge_perm)


def test_vertex_routes_map_real_vertices(graphs):
    """With the unified layout a shard's sorted ids have gaps: the routes
    must still carry every real vertex's value to its sorted row."""
    _, sg, _, _ = graphs
    from vectorgraphlibrary_tpu_torch.config import TraversalDirection as T
    from vectorgraphlibrary_tpu_torch.models import common
    for g in sg.shards:
        x = torch.arange(g.v_pad, dtype=torch.int32)
        for d, dg in ((T.SCATTER, g.outgoing), (T.GATHER, g.incoming)):
            y = common.to_direction(g, x, T.ORIGINAL, d)
            real = dg.sorted_to_orig < g.v
            assert torch.equal(y[real], dg.sorted_to_orig[real])
            back = common.to_direction(g, y, d, T.ORIGINAL)
            assert torch.equal(back, x)
        s_of_g = common.to_direction(
            g, common.to_direction(g, x, T.ORIGINAL, T.GATHER), T.GATHER,
            T.SCATTER)
        real = g.outgoing.sorted_to_orig < g.v
        assert torch.equal(s_of_g[real], g.outgoing.sorted_to_orig[real])


def test_shard_edge_values_in_csr_slot_order(graphs):
    ec, sg, hosts, _ = graphs
    arrays = sb.shard_edge_values(ec.weights, sg, ec, hosts, pad_value=-1.0)
    assert len(arrays) == N_SHARDS
    for s, (ea, g) in enumerate(zip(arrays, sg.shards)):
        m = ec.dst_ids % N_SHARDS == s
        for h, dg, dv in ((hosts[s][0], g.outgoing, ea.outgoing),
                          (hosts[s][1], g.incoming, ea.incoming)):
            assert dv.flat.shape == (dg.e_pad,)
            want = ec.weights[m][h.edge_perm[:dg.e]]
            np.testing.assert_array_equal(dv.flat[:dg.e].numpy(), want)
            assert bool((dv.flat[dg.e:] == -1.0).all())


@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_estimated_shard_slots_equals_reference(graphs, n_shards):
    ec, sg, _, _ = graphs
    jec = jgen.rmat(scale=10, avg_degree=8, seed=3, weighted=True)
    got = sb.estimated_shard_slots(ec, n_shards)
    assert got == jsb.estimated_shard_slots(jec, n_shards)
    if n_shards == N_SHARDS:
        # the natural layouts bound the unified one from below
        assert got <= max(g.advance_route.n for g in sg.shards)


def test_entry_points_default_to_the_card():
    """The new entry points run on the card unless the caller asks for the
    CPU: their device defaults to cuda, and without a card they raise."""
    import inspect
    from vectorgraphlibrary_tpu_torch.graph import persistence
    from vectorgraphlibrary_tpu_torch.parallel import mesh
    for fn in (sb.import_sharded, sb.import_shard,
               persistence.load_sharded_graph, mesh.init_distributed,
               mesh.make_mesh, mesh.default_mesh):
        assert inspect.signature(fn).parameters["device"].default == "cuda", \
            fn.__name__
    if not torch.cuda.is_available():
        ec = generation.rmat(scale=6, avg_degree=4, seed=1)
        with pytest.raises((RuntimeError, AssertionError)):
            sb.import_sharded(ec, 2)
