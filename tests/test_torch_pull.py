"""PyTorch port, the CSR pull: the pull kernel's plain version
(ops/cuda/pull_reduce.pull_reduce_ref) against the JAX package's
advance_pull_value (its route kernels in Pallas interpret mode) on an RMAT
graph, a uniform graph with self-loops and a graph with huge rows in both
directions, without and with edge weights (f32 and i32, every weight op);
the kernel's work units (ops/advance.row_groups); and CPU runs of PageRank
and DO-BFS, which launch no kernel.

Tolerance: f32 sums at rtol 1e-5 / atol 1e-6, because a row's sum is taken
in CSR order, not in the reference's tile order; min, max, or and integers
exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from vectorgraphlibrary_tpu.config import TraversalDirection as JDir
from vectorgraphlibrary_tpu.graph.device import import_graph as jimport_graph
from vectorgraphlibrary_tpu.graph.edges import (
    build_edge_array_from_host as jbuild_edge_array)
from vectorgraphlibrary_tpu.io import generation as jgeneration
from vectorgraphlibrary_tpu.io.edges_container import EdgesContainer
from vectorgraphlibrary_tpu.ops import advance as jadvance

from vectorgraphlibrary_tpu_torch.config import TraversalDirection as TDir
from vectorgraphlibrary_tpu_torch.graph.device import import_graph as timport_graph
from vectorgraphlibrary_tpu_torch.graph.edges import (
    build_edge_array_from_host as tbuild_edge_array)
from vectorgraphlibrary_tpu_torch.models import bfs as tbfs
from vectorgraphlibrary_tpu_torch.models import common as tcommon
from vectorgraphlibrary_tpu_torch.models import pr as tpr
from vectorgraphlibrary_tpu_torch.ops import advance as tadvance
from vectorgraphlibrary_tpu_torch.ops.cuda import pull_reduce as pr_mod
from vectorgraphlibrary_tpu_torch.ops.cuda import push_expand as pe_mod

ADD_TOL = dict(rtol=1e-5, atol=1e-6)


def _edges(kind):
    if kind == "rmat":
        return jgeneration.rmat(scale=10, avg_degree=8, seed=5)
    rng = np.random.default_rng(11)
    v, e = 900, 9000
    src = rng.integers(0, v, e).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    src[:50] = dst[:50]                      # self-loops
    if kind == "hub":
        # vertex 3 has 2,100 in-edges (a wide huge row: over 4 chunks of
        # 512), vertex 7 600 out-edges (a huge row, over the 256-degree
        # threshold), both with self-loops
        src[:2100], dst[:2100] = rng.integers(0, v, 2100), 3
        src[2100:2700], dst[2100:2700] = 7, rng.integers(0, v, 600)
        src[2700:2710] = dst[2700:2710] = 3
        src[2710:2720] = dst[2710:2720] = 7
    return EdgesContainer(src_ids=src, dst_ids=dst, vertices_count=v)


@pytest.fixture(scope="module")
def graphs():
    cache = {}

    def get(kind):
        if kind not in cache:
            ec = _edges(kind)
            cache[kind] = (ec, jimport_graph(ec), timport_graph(ec, device="cpu"))
        return cache[kind]
    return get


# (direction, combine, exclude_self_loops, src_in_src_order, dtype): the
# pulls of tests/test_torch_advance.py, then min and max over i32 and f32
PULLS = {
    "G-add-noloops": ("G", "add", True, False, "f32"),
    "S-add": ("S", "add", False, False, "f32"),
    "S-min": ("S", "min", False, False, "f32"),
    "G-or-bool": ("G", "or", False, False, "bool"),
    "S-add-srcorder": ("S", "add", False, True, "f32"),
    "G-or-bool-srcorder": ("G", "or", False, True, "bool"),
    "G-or-i32-srcorder": ("G", "or", False, True, "i32"),
    "G-min-i32": ("G", "min", False, False, "i32"),
    "S-min-i32-noloops": ("S", "min", True, False, "i32"),
    "G-max-i32": ("G", "max", False, True, "i32"),
    "S-max-i32": ("S", "max", False, False, "i32"),
    "G-min-f32-noloops": ("G", "min", True, False, "f32"),
    "S-min-f32-srcorder": ("S", "min", False, True, "f32"),
    "G-max-f32": ("G", "max", False, False, "f32"),
    "S-max-f32-noloops": ("S", "max", True, False, "f32"),
}


def _dirs(name):
    return {"G": (JDir.GATHER, TDir.GATHER),
            "S": (JDir.SCATTER, TDir.SCATTER)}[name]


def _input(rng, dtype, n):
    if dtype == "f32":
        return rng.uniform(-5, 5, n).astype(np.float32)
    if dtype == "i32":
        # full int32 range: words with bit 31 set must OR unsigned-exact
        x = rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64).astype(np.int32)
        x[::7] |= np.int32(-2**31)
        return x
    return rng.integers(0, 2, n).astype(bool)


@pytest.mark.parametrize("kind", ["rmat", "selfloops", "hub"])
@pytest.mark.parametrize("case", list(PULLS))
def test_pull_reduce_ref_matches_jax(graphs, kind, case):
    d, combine, excl, src_order, dtype = PULLS[case]
    _, jg, tg = graphs(kind)
    x = _input(np.random.default_rng(4), dtype, jg.v_pad)
    jd, td = _dirs(d)
    want = np.asarray(jadvance.advance_pull_value(
        jg, jnp.asarray(x), combine, exclude_self_loops=excl, direction=jd,
        src_in_src_order=src_order))

    # the port's pull by hand: bool as int8 any01, the vertex route into the
    # direction's ordering, then the kernel's plain version
    xt, op = torch.from_numpy(x), combine
    if dtype == "bool":
        xt, op = xt.to(torch.int8), "any01"
    if src_order:
        src_side = TDir.SCATTER if td == TDir.GATHER else TDir.GATHER
        xt = tcommon.to_direction(tg, xt, src_side, td)
    dg = tg.direction(td)
    got = pr_mod.pull_reduce_ref(dg.row_ptr, dg.col_idx, xt, op, excl)
    if dtype == "bool":
        got = got > 0
    got = got.numpy()
    assert got.dtype == want.dtype
    if combine == "add":
        np.testing.assert_allclose(got, want, **ADD_TOL)
    else:
        np.testing.assert_array_equal(got, want)
    # and advance_pull_value itself, which takes the same path on the CPU
    full = tadvance.advance_pull_value(tg, torch.from_numpy(x), combine,
                                       exclude_self_loops=excl, direction=td,
                                       src_in_src_order=src_order)
    np.testing.assert_array_equal(full.numpy(), got)


@pytest.fixture(scope="module")
def wgraphs():
    """kind -> (JAX graph, port graph, {dtype: (JAX EdgeArray, port
    EdgeArray)}): f32 weights in [1, 100) and small int32 ones."""
    cache = {}

    def get(kind):
        if kind not in cache:
            ec = _edges(kind)
            rng = np.random.default_rng(17)
            values = {"f32": rng.uniform(1, 100, ec.edges_count)
                      .astype(np.float32),
                      "i32": rng.integers(-50, 50, ec.edges_count)
                      .astype(np.int32)}
            jhost, thost = [], []
            jg = jimport_graph(ec, _host_out=jhost, keep_edge_slots=True)
            tg = timport_graph(ec, device="cpu", _host_out=thost)
            cache[kind] = (jg, tg, {
                k: (jbuild_edge_array(w, jg, jhost[0], jhost[1]),
                    tbuild_edge_array(w, tg, thost[0], thost[1]))
                for k, w in values.items()})
        return cache[kind]
    return get


# (direction, combine, weight_op, exclude_self_loops, dtype)
WEIGHTED = {
    "G-min-add": ("G", "min", "add", False, "f32"),          # SSSP
    "G-max-min": ("G", "max", "min", False, "f32"),          # SSWP
    "S-min-add-noloops": ("S", "min", "add", True, "f32"),
    "S-max-max": ("S", "max", "max", False, "f32"),
    "G-min-mul": ("G", "min", "mul", False, "f32"),
    "G-add-mul-noloops": ("G", "add", "mul", True, "f32"),
    "S-add-add": ("S", "add", "add", False, "f32"),
    "G-min-add-i32": ("G", "min", "add", False, "i32"),
    "S-max-min-i32-noloops": ("S", "max", "min", True, "i32"),
    "G-add-mul-i32": ("G", "add", "mul", False, "i32"),
}


@pytest.mark.parametrize("kind", ["rmat", "hub"])
@pytest.mark.parametrize("case", list(WEIGHTED))
def test_pull_reduce_ref_with_weights_matches_jax(wgraphs, kind, case):
    """The plain version with edge weights in CSR slot order against the
    JAX package's fused finish, which reads them in route-slot order: min
    and max bit for bit, integers exactly, f32 sums at ADD_TOL."""
    d, combine, wop, excl, dtype = WEIGHTED[case]
    jg, tg, eas = wgraphs(kind)
    jea, tea = eas[dtype]
    rng = np.random.default_rng(6)
    x = (rng.uniform(0, 50, jg.v_pad).astype(np.float32) if dtype == "f32"
         else rng.integers(-1000, 1000, jg.v_pad).astype(np.int32))
    jd, td = _dirs(d)
    want = np.asarray(jadvance.advance_pull_value(
        jg, jnp.asarray(x), combine, edge_values=jea.direction(jd),
        weight_op=wop, exclude_self_loops=excl, direction=jd))
    dg = tg.direction(td)
    got = pr_mod.pull_reduce_ref(dg.row_ptr, dg.col_idx, torch.from_numpy(x),
                                 combine, excl,
                                 weights=tea.direction(td).flat,
                                 weight_op=wop).numpy()
    assert got.dtype == want.dtype
    if combine == "add" and dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    else:
        np.testing.assert_array_equal(got, want)
    # the wrapper takes the plain version for a CPU tensor, groups or not
    full = pr_mod.pull_reduce(dg.row_ptr, dg.col_idx, torch.from_numpy(x),
                              combine, excl, tadvance.row_groups(dg),
                              weights=tea.direction(td).flat, weight_op=wop)
    np.testing.assert_array_equal(full.numpy(), got)


def test_pull_reduce_weights_come_with_a_weight_op():
    row_ptr = torch.tensor([0, 2, 3], dtype=torch.int32)
    col_idx = torch.tensor([1, 0, 1], dtype=torch.int32)
    x = torch.tensor([1.0, 5.0])
    w = torch.tensor([10.0, 20.0, 30.0])
    got = pr_mod.pull_reduce(row_ptr, col_idx, x, "min", weights=w,
                             weight_op="add")
    np.testing.assert_array_equal(got.numpy(), [15.0, 35.0])
    for kw in (dict(weights=w), dict(weight_op="add"),
               dict(weights=w, weight_op="sub")):
        with pytest.raises(ValueError):
            pr_mod.pull_reduce(row_ptr, col_idx, x, "min", **kw)


@pytest.mark.parametrize("kind", ["rmat", "hub"])
@pytest.mark.parametrize("d", ["G", "S"])
def test_row_groups_cover_the_rows(graphs, kind, d):
    """Ascending row ends up to v_pad, thread counts the kernel takes, one
    block per wide huge row and a warp per other huge row, each bucket's
    rows in a group of width / UNROLL threads (1 to 32)."""
    _, _, tg = graphs(kind)
    dg = tg.direction(_dirs(d)[1])
    groups = tadvance.row_groups(dg)
    ends = [r for r, _ in groups]
    assert ends == sorted(ends) and ends[-1] == dg.v_pad
    assert len(groups) <= pr_mod.MAX_GROUPS
    assert all(g in pr_mod.GROUPS for _, g in groups)
    assert len({g for _, g in groups}) == len(groups)

    def group_of(row):
        return next(g for r, g in groups if row < r)
    if kind == "hub":
        h = dg.huge
        assert h is not None and h.n_rows >= 1
        degs = dg.degrees.numpy()
        assert h.n_wide_rows == int((degs > 4 * h.chunk_w).sum())
        assert h.n_wide_rows == (1 if d == "G" else 0)
        for r in range(h.n_rows):
            assert group_of(r) == (pr_mod.BLOCK if r < h.n_wide_rows else 32)
    for b in dg.buckets:
        assert group_of(b.row_start) == group_of(b.row_start + b.rows - 1) \
            == min(max(b.width // pr_mod.UNROLL, 1), 32)
    degs = dg.degrees.numpy()
    assert all(group_of(r) == 1 for r in np.flatnonzero(degs == 0)[:50])


def test_cpu_runs_launch_no_kernel(graphs):
    ec, _, tg = graphs("rmat")
    pr_mod.pull_reduce.launches = 0
    pe_mod.push_expand.launches = 0
    tpr.vgl_page_rank(tg, max_iterations=3, use_convergence=False)
    trace = []
    tbfs.vgl_bfs_device(tg, tcommon.select_random_source(ec, seed=2),
                        id_cap=64, edge_cap=512, trace=trace)
    assert {t[0] for t in trace} == {"td", "bu"}
    assert pr_mod.pull_reduce.launches == 0
    assert pe_mod.push_expand.launches == 0
