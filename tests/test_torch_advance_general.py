"""PyTorch port, the general advance and what comes with it: advance_pull
(user edge ops over source arrays, destination arrays and edge values, with
and without a source mask) on TILE_CSR, CSR and EDGES_LIST graphs,
advance_pull_fast (the same exact mask after the edge op) and
advance_pull_routed (an identity put into the source vector before it),
compute and reduce with a frontier, import_graph(graph_format=,
keep_edge_slots=), and the pull kernel's segment-reduce entry, against the
JAX package on the same graphs (its routed paths and Pallas in interpret
mode, as tests/conftest.py sets).

Tolerance: f32 sums at rtol 1e-5 / atol 1e-6 (the port sums each row in
another order than the reference's tiles, segments or scatter); min, max
and integers exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from vectorgraphlibrary_tpu.config import GraphFormat as JFormat
from vectorgraphlibrary_tpu.config import TraversalDirection as JDir
from vectorgraphlibrary_tpu.graph import frontier as jfrontier
from vectorgraphlibrary_tpu.graph.device import import_graph as jimport_graph
from vectorgraphlibrary_tpu.graph.edges import (
    build_edge_array_from_host as jbuild_edge_array)
from vectorgraphlibrary_tpu.models import common as jcommon
from vectorgraphlibrary_tpu.ops import advance as jadvance
from vectorgraphlibrary_tpu.ops import monoid as jmonoid
from vectorgraphlibrary_tpu.ops.compute import compute as jcompute
from vectorgraphlibrary_tpu.ops.reduce import reduce as jreduce

from vectorgraphlibrary_tpu_torch.config import GraphFormat as TFormat
from vectorgraphlibrary_tpu_torch.config import TraversalDirection as TDir
from vectorgraphlibrary_tpu_torch.graph import frontier as tfrontier
from vectorgraphlibrary_tpu_torch.graph.device import import_graph as timport_graph
from vectorgraphlibrary_tpu_torch.graph.edges import (
    build_edge_array_from_host as tbuild_edge_array)
from vectorgraphlibrary_tpu_torch.models import common as tcommon
from vectorgraphlibrary_tpu_torch.ops import advance as tadvance
from vectorgraphlibrary_tpu_torch.ops import monoid as tmonoid
from vectorgraphlibrary_tpu_torch.ops.compute import compute as tcompute
from vectorgraphlibrary_tpu_torch.ops.cuda import pull_reduce as pl
from vectorgraphlibrary_tpu_torch.ops.reduce import reduce as treduce

ADD_TOL = dict(rtol=1e-5, atol=1e-6)
FORMATS = ["vect_csr", "csr", "el"]
DIRS = {"G": (JDir.GATHER, TDir.GATHER), "S": (JDir.SCATTER, TDir.SCATTER)}


@pytest.fixture(scope="module")
def graphs(small_rmat):
    """format -> (JAX graph, JAX EdgeArray, port graph, port EdgeArray) of
    weighted RMAT-10 (hub rows included), built once each."""
    ec = small_rmat.with_random_weights(seed=21)
    cache = {}

    def get(fmt):
        if fmt not in cache:
            jhost, thost = [], []
            jg = jimport_graph(ec, graph_format=JFormat.parse(fmt),
                               _host_out=jhost)
            jea = jbuild_edge_array(ec.weights, jg, jhost[0], jhost[1])
            tg = timport_graph(ec, graph_format=TFormat.parse(fmt),
                               device="cpu", _host_out=thost)
            tea = tbuild_edge_array(ec.weights, tg, thost[0], thost[1])
            cache[fmt] = (jg, jea, tg, tea)
        return cache[fmt]
    return get


def _cmp(got, want, combine):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if combine == "add" and np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, **ADD_TOL)
    else:
        np.testing.assert_array_equal(got, want)


# name -> (combine, edge op over (src, dst, w) of either package: dicts of
# [E, 1] (or tile) arrays and the edge values, which both packages' arrays
# take through +, *, where-free arithmetic and their own min/max)
def _ops(xp):
    mn, mx = (jnp.minimum, jnp.maximum) if xp == "jax" else (torch.minimum,
                                                            torch.maximum)
    return {
        "min-src": ("min", lambda s, d, w: s["x"]),
        "max-src": ("max", lambda s, d, w: s["x"]),
        "add-src": ("add", lambda s, d, w: s["x"]),
        "min-src+w": ("min", lambda s, d, w: s["x"] + w),
        "max-min(src,w)": ("max", lambda s, d, w: mn(s["x"], w)),
        "add-src*dst": ("add", lambda s, d, w: s["x"] * d["y"]),
        "min-w-dst": ("min", lambda s, d, w: mx(w - d["y"], s["x"] * 0.5)),
        "max-int-src+dst": ("max", lambda s, d, w: s["k"] + d["k"]),
    }


CASES = list(_ops("jax"))


def _arrays(v_pad, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 50, v_pad).astype(np.float32)
    y = rng.uniform(0, 3, v_pad).astype(np.float32)
    k = rng.integers(-1000, 1000, v_pad).astype(np.int32)
    act = rng.random(v_pad) < 0.4
    return x, y, k, act


@pytest.mark.parametrize("active", [False, True])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("fmt", FORMATS)
def test_advance_pull_matches_jax(graphs, fmt, case, active):
    jg, jea, tg, tea = graphs(fmt)
    d = "GS"[CASES.index(case) % 2]
    jd, td = DIRS[d]
    x, y, k, act = _arrays(jg.v_pad, len(case))
    combine, jop = _ops("jax")[case]
    _, top = _ops("torch")[case]
    jsrc = {"x": jnp.asarray(x), "k": jnp.asarray(k)}
    jdst = {"y": jnp.asarray(y), "k": jnp.asarray(k)}
    tsrc = {"x": torch.from_numpy(x), "k": torch.from_numpy(k)}
    tdst = {"y": torch.from_numpy(y), "k": torch.from_numpy(k)}
    want = jadvance.advance_pull(
        jg, jsrc, jop, combine, dst_arrays=jdst,
        edge_values=jea.direction(jd),
        src_active=jnp.asarray(act) if active else None, direction=jd)
    got = tadvance.advance_pull(
        tg, tsrc, top, combine, dst_arrays=tdst,
        edge_values=tea.direction(td),
        src_active=torch.from_numpy(act) if active else None, direction=td)
    _cmp(got, want, combine)


@pytest.mark.parametrize("d", ["G", "S"])
def test_advance_pull_int_edge_values_and_bool(graphs, d):
    """int32 edge values (as max-flow's arc ids) under min with a mask, and
    a bool or over a destination test, on the CSR graph."""
    jg, jea, tg, tea = graphs("csr")
    jd, td = DIRS[d]
    jw = jea.direction(jd)
    tw = tea.direction(td)
    import dataclasses
    jw = dataclasses.replace(jw, flat=jnp.asarray(
        np.arange(jw.flat.shape[0], dtype=np.int32)))
    tw = dataclasses.replace(tw, flat=torch.arange(tw.flat.shape[0],
                                                   dtype=torch.int32))
    _, y, _, act = _arrays(jg.v_pad, 5)
    want = jadvance.advance_pull(jg, {}, lambda s, dd, w: w, "min",
                                 edge_values=jw, src_active=jnp.asarray(act),
                                 direction=jd)
    got = tadvance.advance_pull(tg, {}, lambda s, dd, w: w, "min",
                                edge_values=tw,
                                src_active=torch.from_numpy(act),
                                direction=td)
    _cmp(got, want, "min")
    want = jadvance.advance_pull(jg, {"y": jnp.asarray(y)},
                                 lambda s, dd, w: s["y"] > dd["y"], "or",
                                 dst_arrays={"y": jnp.asarray(y)},
                                 direction=jd)
    got = tadvance.advance_pull(tg, {"y": torch.from_numpy(y)},
                                lambda s, dd, w: s["y"] > dd["y"], "or",
                                dst_arrays={"y": torch.from_numpy(y)},
                                direction=td)
    _cmp(got, want, "or")


@pytest.mark.parametrize("d", ["G", "S"])
def test_advance_pull_fast_masks_after_the_edge_op(graphs, d):
    """advance_pull_fast's src_active is an exact mask after the edge op: an
    inactive source adds nothing even where the op would turn the identity
    into something else (x + 1 under add), unlike advance_pull_routed's."""
    jg, jea, tg, tea = graphs("vect_csr")
    jd, td = DIRS[d]
    x, _, _, act = _arrays(jg.v_pad, 9)
    want = jadvance.advance_pull_fast(
        jg, {"x": jnp.asarray(x)}, lambda s, dd, w: s["x"] + 1.0, "add",
        src_active=jnp.asarray(act), direction=jd)
    got = tadvance.advance_pull_fast(
        tg, {"x": torch.from_numpy(x)}, lambda s, dd, w: s["x"] + 1.0, "add",
        src_active=torch.from_numpy(act), direction=td)
    _cmp(got, want, "add")
    src = TDir.SCATTER if td == TDir.GATHER else TDir.GATHER
    absorbed = tadvance.advance_pull_routed(
        tg, tcommon.to_direction(tg, torch.from_numpy(x), td, src),
        lambda v, i, dd, w: v + 1.0, "add",
        src_active=tcommon.to_direction(tg, torch.from_numpy(act), td, src),
        direction=td)
    assert not np.allclose(absorbed.numpy(), got.numpy())


# name -> (combine, routed edge op (vals, src_ids, dst_ids, w), use w)
ROUTED = {
    "add": ("add", lambda v, i, dd, w: v, False),
    "min-v+w": ("min", lambda v, i, dd, w: v + w, True),
    "min-no-self-loops": ("min", None, False),
}


@pytest.mark.parametrize("active", [False, True])
@pytest.mark.parametrize("case", list(ROUTED))
@pytest.mark.parametrize("d", ["G", "S"])
def test_advance_pull_routed_matches_jax(graphs, d, case, active):
    jg, jea, tg, tea = graphs("vect_csr")
    jd, td = DIRS[d]
    combine, op, use_w = ROUTED[case]
    x, _, _, act = _arrays(jg.v_pad, 13)
    if op is None:
        jop = lambda v, i, dd, w: jnp.where(i == dd, jnp.inf, v)   # noqa
        top = lambda v, i, dd, w: torch.where(i == dd, torch.inf, v)  # noqa
    else:
        jop = top = op
    src_j = JDir.SCATTER if jd == JDir.GATHER else JDir.GATHER
    jx = jcommon.to_direction(jg, jnp.asarray(x), jd, src_j)
    ja = jcommon.to_direction(jg, jnp.asarray(act), jd, src_j)
    want = jadvance.advance_pull_routed(
        jg, jx, jop, combine,
        edge_values=jea.direction(jd) if use_w else None,
        src_active=ja if active else None, direction=jd)
    got = tadvance.advance_pull_routed(
        tg, torch.from_numpy(np.array(jx)), top, combine,
        edge_values=tea.direction(td) if use_w else None,
        src_active=torch.from_numpy(np.array(ja)) if active else None,
        direction=td)
    _cmp(got, want, combine)


@pytest.mark.parametrize("op", ["add", "max"])
@pytest.mark.parametrize("d", ["G", "S"])
def test_compute_and_reduce_with_a_frontier(graphs, d, op):
    """Only the frontier's vertices take the update and count in the
    reduction; the frontier's direction gives the degrees."""
    jg, _, tg, _ = graphs("vect_csr")
    jd, td = DIRS[d]
    x, _, _, act = _arrays(jg.v_pad, 17)
    jf = jfrontier.from_mask(jg, jnp.asarray(act), jd)
    tf = tfrontier.from_mask(tg, torch.from_numpy(act), td)

    def jop(ids, degs, arr):
        return {"x": arr["x"] * 2.0 + degs.astype(jnp.float32)}

    def top(ids, degs, arr):
        return {"x": arr["x"] * 2.0 + degs.to(torch.float32)}
    want = jcompute(jg, {"x": jnp.asarray(x)}, jop, frontier=jf)["x"]
    got = tcompute(tg, {"x": torch.from_numpy(x)}, top, frontier=tf)["x"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jreduce(jg, jnp.asarray(x), op, frontier=jf)
    got = treduce(tg, torch.from_numpy(x), op, frontier=tf)
    _cmp(got, want, op)
    # without a frontier: every real vertex
    _cmp(treduce(tg, torch.from_numpy(x), op),
         jreduce(jg, jnp.asarray(x), op), op)


@pytest.mark.parametrize("keep", [None, False, True])
@pytest.mark.parametrize("fmt", ["vect_csr", "csr_vg", "csr", "el"])
def test_import_graph_format(small_ru, fmt, keep):
    """Only TILE_CSR builds the advance route, as in the reference; every
    format holds the same CSR, and keep_edge_slots changes nothing."""
    tg = timport_graph(small_ru, graph_format=TFormat.parse(fmt),
                       device="cpu", keep_edge_slots=keep)
    jg = jimport_graph(small_ru, graph_format=JFormat.parse(fmt),
                       keep_edge_slots=keep)
    assert tg.graph_format == TFormat.parse(fmt)
    assert (tg.advance_route is None) == (jg.advance_route is None) \
        == (fmt != "vect_csr")
    assert tg.vertex_route_s_from_g is not None
    for d in ("G", "S"):
        jd, td = DIRS[d]
        np.testing.assert_array_equal(tg.direction(td).row_ptr.numpy(),
                                      np.asarray(jg.direction(jd).row_ptr))
        np.testing.assert_array_equal(tg.direction(td).col_idx.numpy(),
                                      np.asarray(jg.direction(jd).col_idx))


SEGMENT_CASES = [("add", np.float32), ("min", np.float32),
                 ("max", np.float32), ("add", np.int32), ("min", np.int32),
                 ("max", np.int32), ("or", np.int32), ("any01", np.int8),
                 ("min", np.int8)]


@pytest.mark.parametrize("op,dtype", SEGMENT_CASES)
def test_segment_reduce_plain_version(graphs, op, dtype):
    """The segment-reduce entry's plain version over the incoming CSR's
    rows, one message per slot (padding slots past e present), equals the
    port's Monoid.segment_reduce and the JAX package's segment reduction by
    row id."""
    _, _, tg, _ = graphs("csr")
    dg = tg.incoming
    rng = np.random.default_rng(3)
    if dtype == np.float32:
        x = rng.uniform(-5, 5, dg.e_pad).astype(np.float32)
    elif op == "any01":
        x = rng.integers(0, 2, dg.e_pad).astype(np.int8)
    else:
        info = np.iinfo(dtype)
        x = rng.integers(info.min, info.max, dg.e_pad,
                         dtype=np.int64).astype(dtype)
    got = pl.segment_reduce(dg.row_ptr, torch.from_numpy(x), op)
    lengths = dg.degrees.long()
    want_t = tmonoid.get(op).segment_reduce(torch.from_numpy(x[:dg.e]),
                                            lengths)
    assert torch.equal(got, want_t)
    rows = np.repeat(np.arange(dg.v_pad), dg.degrees.numpy())
    jmon = jmonoid.get(op)
    want_j = jmon.segment_reduce(jnp.asarray(x[:dg.e]), jnp.asarray(rows),
                                 dg.v_pad, True)
    if op == "any01":       # JAX leaves an empty segment at int8 min
        want_j = jnp.maximum(want_j, 0)
    _cmp(got, want_j, op)
