"""PyTorch port, host layer: the port's host CSRs, tiles, huge chunks, route
permutation and slot flags are bit-identical to the JAX package's, its gather
indices equal the JAX route applied to arange(n), and `from_host` fed by the
JAX package's host CSRs equals the port's own `import_graph`."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from vectorgraphlibrary_tpu.graph import build as jbuild
from vectorgraphlibrary_tpu.graph import route_build as jroute_build
from vectorgraphlibrary_tpu.graph.device import import_graph as jimport_graph
from vectorgraphlibrary_tpu.io.edges_container import EdgesContainer
from vectorgraphlibrary_tpu.ops.pallas import route_fused

from vectorgraphlibrary_tpu_torch.graph import build as tbuild
from vectorgraphlibrary_tpu_torch.graph import route_build as troute_build
from vectorgraphlibrary_tpu_torch.graph.device import (from_host,
                                                       import_graph as timport_graph)
from vectorgraphlibrary_tpu_torch.io import generation as tgen


def selfloop_graph() -> EdgesContainer:
    """Random graph with guaranteed self-loops (test_route_fused._value_graph
    without weights)."""
    rng = np.random.default_rng(0)
    v, e = 900, 9000
    src = rng.integers(0, v, e).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    src[:50] = dst[:50]
    return EdgesContainer(src_ids=src, dst_ids=dst, vertices_count=v)


GRAPHS = ["small_rmat", "small_ru", "selfloops"]


@pytest.fixture(scope="module")
def graphs(small_rmat, small_ru):
    """name -> (ec, jax host CSRs [out, in], jax graph, port graph on cpu)."""
    out = {}
    for name, ec in (("small_rmat", small_rmat), ("small_ru", small_ru),
                     ("selfloops", selfloop_graph())):
        host = []
        jg = jimport_graph(ec, _host_out=host)
        out[name] = (ec, host, jg, timport_graph(ec, device="cpu"))
    return out


def test_generators_match():
    from vectorgraphlibrary_tpu.io import generation as jgen
    for kind, scale, deg, seed in (("rmat", 10, 8, 3), ("ru", 9, 5, 7)):
        a = jgen.generate(kind, scale, deg, seed)
        b = tgen.generate(kind, scale, deg, seed)
        np.testing.assert_array_equal(a.src_ids, b.src_ids)
        np.testing.assert_array_equal(a.dst_ids, b.dst_ids)
        np.testing.assert_array_equal(a.weights, b.weights)


def _assert_host_equal(a, b):
    for f in ("vertices_count", "vertices_pad", "edges_count", "edges_pad"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("row_ptr", "col_idx", "degrees", "edge_perm", "sorted_to_orig",
              "orig_to_sorted"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert (a.huge is None) == (b.huge is None)
    if a.huge is not None:
        for f in ("chunk_w", "n_rows", "n_chunks", "n_chunks_pad"):
            assert getattr(a.huge, f) == getattr(b.huge, f), f
        for f in ("adj", "eidx", "seg_ids"):
            np.testing.assert_array_equal(getattr(a.huge, f),
                                          getattr(b.huge, f), err_msg=f)
    assert len(a.buckets) == len(b.buckets)
    for ba, bb in zip(a.buckets, b.buckets):
        assert (ba.width, ba.row_start, ba.rows, ba.rows_pad) == \
            (bb.width, bb.row_start, bb.rows, bb.rows_pad)
        np.testing.assert_array_equal(ba.adj, bb.adj)
        np.testing.assert_array_equal(ba.eidx, bb.eidx)


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("direction", ["out", "in"])
def test_host_csr_and_tiles_identical(graphs, name, direction):
    ec, host, _, _ = graphs[name]
    src, dst = ((ec.src_ids, ec.dst_ids) if direction == "out"
                else (ec.dst_ids, ec.src_ids))
    mine = tbuild.build_directed_csr(src, dst, ec.vertices_count)
    _assert_host_equal(host[0 if direction == "out" else 1], mine)
    # and the JAX package's build_directed_csr, called the same way
    _assert_host_equal(jbuild.build_directed_csr(src, dst, ec.vertices_count),
                       mine)


@pytest.mark.parametrize("name", GRAPHS)
def test_perm_and_flags_identical(graphs, name):
    ec, host, _, _ = graphs[name]
    j = jroute_build.build_pull_permutation(host[0], host[1])
    t = troute_build.build_pull_permutation(host[0], host[1])
    for a, b in zip(j, t):
        np.testing.assert_array_equal(a, b)
    perm, _, _, m_src, m_dst = t
    loops = ec.src_ids == ec.dst_ids
    for m in (m_src, m_dst):
        np.testing.assert_array_equal(
            jroute_build._slot_flags(len(perm), m, loops),
            troute_build._slot_flags(len(perm), m, loops))


def _jax_route_of_iota(plan, inverse):
    iota = jnp.arange(plan.n, dtype=jnp.int32)
    return np.asarray(route_fused.apply_route_fused(plan, iota,
                                                    inverse=inverse))


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("route", ["advance_route", "vertex_route_s_from_g",
                                   "vertex_route_s_from_o",
                                   "vertex_route_g_from_o"])
def test_gather_index_is_the_jax_route(graphs, name, route):
    """fwd_idx/inv_idx are what the JAX route makes of arange(n): forward
    y = x[perm] gives y = perm; inverse y[perm] = x gives argsort(perm)."""
    _, _, jg, tg = graphs[name]
    jplan, tplan = getattr(jg, route), getattr(tg, route)
    assert tplan.n == jplan.n
    np.testing.assert_array_equal(tplan.fwd_idx.numpy(),
                                  _jax_route_of_iota(jplan, False))
    np.testing.assert_array_equal(tplan.inv_idx.numpy(),
                                  _jax_route_of_iota(jplan, True))


@pytest.mark.parametrize("name", GRAPHS)
def test_advance_flags_match_jax_finish(graphs, name):
    """The port's per-slot flag bytes mask exactly the slots the JAX fused
    finish masks (valid bit, self-loop bit), both directions."""
    _, _, jg, tg = graphs[name]
    plan, tplan = jg.advance_route, tg.advance_route
    iota = jnp.arange(plan.n, dtype=jnp.int32)
    fin = route_fused.FinishSpec(ident=-1, exclude_self_loops=True)
    for inverse, flags, idx in ((False, tplan.flags_fwd, tplan.fwd_idx),
                                (True, tplan.flags_inv, tplan.inv_idx)):
        f = flags.numpy()
        got = np.asarray(route_fused.apply_route_fused(
            plan, iota, inverse=inverse, finish=fin))
        keep = ((f & 1) == 1) & ((f & 2) == 0)
        np.testing.assert_array_equal(got, np.where(keep, idx.numpy(), -1))


def _tensors(obj, prefix=""):
    """Flatten a port graph into {path: tensor or scalar}."""
    import dataclasses
    out = {}
    if isinstance(obj, torch.Tensor):
        out[prefix] = obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            out.update(_tensors(getattr(obj, f.name), f"{prefix}.{f.name}"))
    elif isinstance(obj, (tuple, list)):
        for i, x in enumerate(obj):
            out.update(_tensors(x, f"{prefix}[{i}]"))
    else:
        out[prefix] = obj
    return out


@pytest.mark.parametrize("name", GRAPHS)
def test_from_host_equals_import_graph(graphs, name):
    ec, host, _, tg = graphs[name]
    fg = from_host(host[0], host[1], ec.src_ids == ec.dst_ids,
                   ec.vertices_count, ec.edges_count, device="cpu")
    a, b = _tensors(tg), _tensors(fg)
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert a[k].dtype == b[k].dtype, k
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("name", GRAPHS)
def test_device_arrays_match_jax(graphs, name):
    """Device containers: same values as the JAX package's, buckets seen
    row-major (rows_pad, width)."""
    _, _, jg, tg = graphs[name]
    for d in ("outgoing", "incoming"):
        j, t = getattr(jg, d), getattr(tg, d)
        for f in ("row_ptr", "col_idx", "degrees", "sorted_to_orig",
                  "orig_to_sorted"):
            np.testing.assert_array_equal(np.asarray(getattr(j, f)),
                                          getattr(t, f).numpy(), err_msg=f)
        for jb, tb in zip(j.buckets, t.buckets):
            np.testing.assert_array_equal(
                np.asarray(jb.adj).reshape(tb.rows_pad, tb.width),
                tb.adj.numpy())
        if j.huge is not None:
            np.testing.assert_array_equal(np.asarray(j.huge.adj),
                                          t.huge.adj.numpy())
            np.testing.assert_array_equal(np.asarray(j.huge.seg_ids),
                                          t.huge.seg_ids.numpy())
        assert (j.v, j.v_pad, j.e, j.e_pad) == (t.v, t.v_pad, t.e, t.e_pad)
    assert (jg.out_slots, jg.in_slots) == (tg.out_slots, tg.in_slots)
