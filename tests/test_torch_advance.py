"""PyTorch port, primitives: monoids, the fused value-pull advance,
advance_cells, reduce, compute and reorder against the JAX package on the same
graph (the JAX route in Pallas interpret mode on the CPU).

Tolerance: f32 sums at rtol 1e-5 / atol 1e-6, because per-row sums are taken
in another order than the reference's HIGHEST-precision group matmul; min,
max, or, integers and permutations exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from vectorgraphlibrary_tpu.config import TraversalDirection as JDir
from vectorgraphlibrary_tpu.graph.device import import_graph as jimport_graph
from vectorgraphlibrary_tpu.graph.vertices import (VertexArray as JVertexArray,
                                                   reorder as jreorder)
from vectorgraphlibrary_tpu.io.edges_container import EdgesContainer
from vectorgraphlibrary_tpu.models import common as jcommon
from vectorgraphlibrary_tpu.ops import advance as jadvance
from vectorgraphlibrary_tpu.ops import monoid as jmonoid
from vectorgraphlibrary_tpu.ops.compute import compute as jcompute
from vectorgraphlibrary_tpu.ops.reduce import reduce as jreduce

from vectorgraphlibrary_tpu_torch.config import TraversalDirection as TDir
from vectorgraphlibrary_tpu_torch.graph.device import import_graph as timport_graph
from vectorgraphlibrary_tpu_torch.graph.vertices import (VertexArray as TVertexArray,
                                                         reorder as treorder)
from vectorgraphlibrary_tpu_torch.models import common as tcommon
from vectorgraphlibrary_tpu_torch.ops import advance as tadvance
from vectorgraphlibrary_tpu_torch.ops import monoid as tmonoid
from vectorgraphlibrary_tpu_torch.ops.compute import compute as tcompute
from vectorgraphlibrary_tpu_torch.ops.reduce import reduce as treduce

ADD_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def graphs():
    """test_route_fused._value_graph without weights: 900 vertices, 9000
    edges, 50 self-loops."""
    rng = np.random.default_rng(0)
    v, e = 900, 9000
    src = rng.integers(0, v, e).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    src[:50] = dst[:50]
    ec = EdgesContainer(src_ids=src, dst_ids=dst, vertices_count=v)
    return ec, jimport_graph(ec), timport_graph(ec, device="cpu")


def _dirs(name):
    return {"G": (JDir.GATHER, TDir.GATHER), "S": (JDir.SCATTER, TDir.SCATTER),
            "O": (JDir.ORIGINAL, TDir.ORIGINAL)}[name]


def _cmp(got, want, combine):
    """Exact, except f32 sums (combine "add") at ADD_TOL."""
    got = got.numpy()
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if combine == "add" and np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, **ADD_TOL)
    else:
        np.testing.assert_array_equal(got, want)


# (direction, combine, exclude_self_loops, src_in_src_order, dtype)
PULLS = {
    "G-add-noloops": ("G", "add", True, False, "f32"),     # PageRank
    "S-add": ("S", "add", False, False, "f32"),             # HITS hub phase
    "S-min": ("S", "min", False, False, "f32"),             # CC hook
    "G-or-bool": ("G", "or", False, False, "bool"),         # BFS bottom-up
    "S-add-srcorder": ("S", "add", False, True, "f32"),
}


@pytest.mark.parametrize("case", list(PULLS))
def test_advance_pull_value_matches_jax(graphs, case):
    d, combine, excl, src_order, dtype = PULLS[case]
    _, jg, tg = graphs
    rng = np.random.default_rng(4)
    if dtype == "f32":
        x = rng.uniform(0, 5, jg.v_pad).astype(np.float32)
    else:
        x = rng.integers(0, 2, jg.v_pad).astype(bool)
    jd, td = _dirs(d)
    want = jadvance.advance_pull_value(jg, jnp.asarray(x), combine,
                                       exclude_self_loops=excl, direction=jd,
                                       src_in_src_order=src_order)
    got = tadvance.advance_pull_value(tg, torch.from_numpy(x), combine,
                                      exclude_self_loops=excl, direction=td,
                                      src_in_src_order=src_order)
    _cmp(got, want, combine)


@pytest.mark.parametrize("d", ["G", "S"])
def test_advance_cells_selfloop_counts(graphs, d):
    ec, jg, tg = graphs
    jd, td = _dirs(d)
    want = jadvance.advance_cells(
        jg, lambda s, dd, w: (s == dd).astype(jnp.int32), "add", direction=jd)
    got = tadvance.advance_cells(
        tg, lambda s, dd, w: (s == dd).to(torch.int32), "add", direction=td)
    _cmp(got, want, "add")
    assert int(got.sum()) == int((ec.src_ids == ec.dst_ids).sum())


@pytest.mark.parametrize("op", ["add", "min", "max"])
def test_reduce_matches_jax(graphs, op):
    _, jg, tg = graphs
    x = np.random.default_rng(1).standard_normal(jg.v_pad).astype(np.float32)
    want = jreduce(jg, jnp.asarray(x), op, direction=JDir.GATHER)
    got = treduce(tg, torch.from_numpy(x), op, direction=TDir.GATHER)
    _cmp(got, want, op)


def test_compute_matches_jax(graphs):
    _, jg, tg = graphs
    x = np.random.default_rng(2).standard_normal(jg.v_pad).astype(np.float32)
    want = jcompute(jg, {"r": jnp.asarray(x)},
                    lambda ids, degs, a: {"r": a["r"] * 2.0 + degs},
                    direction=JDir.GATHER)["r"]
    got = tcompute(tg, {"r": torch.from_numpy(x)},
                   lambda ids, degs, a: {"r": a["r"] * 2.0 + degs},
                   direction=TDir.GATHER)["r"]
    _cmp(got, want, "exact")


@pytest.mark.parametrize("pair", ["GS", "SG", "OS", "SO", "OG", "GO"])
def test_reorder_matches_jax(graphs, pair):
    """Reorders between all six ordering pairs; the first v slots are
    contractual (padding slots map to themselves in both packages)."""
    _, jg, tg = graphs
    rng = np.random.default_rng(3)
    x = rng.integers(-2**31, 2**31 - 1, jg.v_pad,
                     dtype=np.int64).astype(np.int32)
    (js, ts), (jd, td) = _dirs(pair[0]), _dirs(pair[1])
    want = jreorder(JVertexArray(values=jnp.asarray(x), direction=js), jg, jd)
    got = treorder(TVertexArray(values=torch.from_numpy(x), direction=ts), tg,
                   td)
    assert got.direction == td
    np.testing.assert_array_equal(got.values.numpy()[:jg.v],
                                  np.asarray(want.values)[:jg.v])


def test_common_helpers_match_jax(graphs):
    ec, jg, tg = graphs
    for fn in ("outdegrees_in", "indegrees_in"):
        for d in ("G", "S"):
            jd, td = _dirs(d)
            np.testing.assert_array_equal(
                getattr(tcommon, fn)(tg, td).numpy()[:jg.v],
                np.asarray(getattr(jcommon, fn)(jg, jd))[:jg.v])
    for seed in range(3):
        assert tcommon.select_random_source(ec, seed) == \
            jcommon.select_random_source(ec, seed)


MONOID_CASES = [("add", "f32"), ("add", "i32"), ("min", "f32"),
                ("min", "i32"), ("max", "f32"), ("max", "i32"),
                ("or", "i32"), ("or", "bool"), ("any01", "i32")]


def _monoid_data(rng, dtype, shape, name):
    if dtype == "f32":
        return rng.standard_normal(shape).astype(np.float32)
    if dtype == "bool":
        return rng.integers(0, 2, shape).astype(bool)
    if name == "any01":
        return rng.integers(0, 2, shape).astype(np.int32)
    # full int32 range: OR words with bit 31 set must stay unsigned-exact
    return rng.integers(-2**31, 2**31 - 1, shape, dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("name,dtype", MONOID_CASES)
def test_monoid_matches_jax(name, dtype):
    rng = np.random.default_rng(9)
    jm, tm = jmonoid.get(name), tmonoid.get(name)
    tdt = {"f32": torch.float32, "i32": torch.int32, "bool": torch.bool}[dtype]
    jdt = {"f32": jnp.float32, "i32": jnp.int32, "bool": jnp.bool_}[dtype]
    if not (name == "min" and dtype == "bool"):
        assert tm.identity(tdt).item() == jm.identity(jdt).item()
    a = _monoid_data(rng, dtype, (64, 16), name)
    b = _monoid_data(rng, dtype, (64, 16), name)
    cmp_name = "add" if name == "add" else "exact"
    _cmp(tm.combine(torch.from_numpy(a), torch.from_numpy(b)),
         jm.combine(jnp.asarray(a), jnp.asarray(b)), cmp_name)
    _cmp(tm.reduce_axis(torch.from_numpy(a), 1),
         jm.reduce_axis(jnp.asarray(a), 1), cmp_name)
    # sorted segments, some empty, incl. a trailing one
    lengths = rng.integers(0, 5, 40)
    lengths[[3, 17, 39]] = 0
    seg = np.repeat(np.arange(40), lengths).astype(np.int32)
    data = _monoid_data(rng, dtype, (len(seg),), name)
    want = jm.segment_reduce(jnp.asarray(data), jnp.asarray(seg), 40,
                             indices_are_sorted=True)
    got = tm.segment_reduce(torch.from_numpy(data),
                            torch.from_numpy(lengths.astype(np.int64)))
    if name == "any01":
        # JAX's segment_max leaves an empty segment at int32 min, not at
        # any01's identity 0; the port gives 0. The one caller, the bool
        # pull, tests > 0, so both give False there.
        want = np.maximum(np.asarray(want), 0)
    _cmp(got, want, cmp_name)
