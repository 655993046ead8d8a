"""PyTorch port, the sparse push and its scatter: advance_push_sparse
(without and with edge weights: SSSP's f32 min of dist + w),
advance_push_sparse_const (the expand-and-scatter kernel's plain version) and
Monoid.scatter_at against the JAX package on RMAT-10 and RU-9, and the
scatter_combine kernel's plain version against the semantics of the TPU
kernel it replaces (apps/exp_push.py `_kern`: out[d] |= 1 for d < V) and of
the XLA scatter beside it (`a_scatter`: .at[d].max(1, mode="drop")).

All comparisons are exact: integer scatters and f32 min/max have one
answer in any order. f32 add sums colliding messages in another order than
XLA, so it is compared at rtol 1e-6 with messages that are exact in f32
(small integers), where any order gives the same sum."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from vectorgraphlibrary_tpu.config import TraversalDirection as JDir
from vectorgraphlibrary_tpu.graph import frontier as jfrontier
from vectorgraphlibrary_tpu.graph.device import import_graph as jimport_graph
from vectorgraphlibrary_tpu.graph.edges import (
    build_edge_array_from_host as jbuild_edge_array)
from vectorgraphlibrary_tpu.ops import advance as jadvance
from vectorgraphlibrary_tpu.ops import monoid as jmonoid

from vectorgraphlibrary_tpu_torch.config import TraversalDirection as TDir
from vectorgraphlibrary_tpu_torch.graph import frontier as tfrontier
from vectorgraphlibrary_tpu_torch.graph.device import import_graph as timport_graph
from vectorgraphlibrary_tpu_torch.graph.edges import (
    build_edge_array_from_host as tbuild_edge_array)
from vectorgraphlibrary_tpu_torch.models import bfs as tbfs
from vectorgraphlibrary_tpu_torch.models import common as tcommon
from vectorgraphlibrary_tpu_torch.ops import advance as tadvance
from vectorgraphlibrary_tpu_torch.ops import monoid as tmonoid
from vectorgraphlibrary_tpu_torch.ops.cuda import push_expand as pe
from vectorgraphlibrary_tpu_torch.ops.cuda import route_gather as rg
from vectorgraphlibrary_tpu_torch.ops.cuda import scatter_combine as sc

INT32_MAX = 2**31 - 1


@pytest.fixture(scope="module")
def graphs(request):
    cache = {}

    def get(name):
        if name not in cache:
            ec = request.getfixturevalue(name)
            cache[name] = (ec, jimport_graph(ec), timport_graph(ec, device="cpu"))
        return cache[name]
    return get


def _i32(rng, shape):
    return rng.integers(-2**31, INT32_MAX, shape, dtype=np.int64).astype(np.int32)


# (combine, message): BFS form = int32 min of the constant level 5 into
# levels with INF for unvisited; max form = int32 max of the source's value
PUSH_FORMS = ["bfs-min", "max"]
# edge capacity against the frontier's degree sum: exact fit, or half of it
# (the edges past the capacity drop)
ECAPS = ["exact", "overflow"]


@pytest.mark.parametrize("graph", ["small_rmat", "small_ru"])
@pytest.mark.parametrize("form", PUSH_FORMS)
@pytest.mark.parametrize("ecap_kind", ECAPS)
def test_advance_push_sparse_matches_jax(graphs, graph, form, ecap_kind):
    _, jg, tg = graphs(graph)
    rng = np.random.default_rng(5)
    mask = rng.random(jg.v_pad) < 0.1
    jf = jfrontier.from_mask(jg, jnp.asarray(mask), JDir.SCATTER)
    tf = tfrontier.from_mask(tg, torch.from_numpy(mask), TDir.SCATTER)
    cap = tcommon.next_pow2(int(tf.size))
    jids, jvalid = jfrontier.compact_ids(jf, cap)
    tids, tvalid = tfrontier.compact_ids(tf, cap)
    deg_sum = int(tf.neighbours_count)
    ecap = deg_sum if ecap_kind == "exact" else deg_sum // 2
    if form == "bfs-min":
        out = np.where(rng.random(jg.v_pad) < 0.5, INT32_MAX,
                       rng.integers(1, 9, jg.v_pad)).astype(np.int32)
        src = {"l": out}
        jop = lambda s, d, w: jnp.zeros_like(s["l"]) + 5
        top = lambda s, d, w: torch.zeros_like(s["l"]) + 5
        combine = "min"
    else:
        out = _i32(rng, jg.v_pad)
        src = {"x": _i32(rng, jg.v_pad)}
        jop = top = lambda s, d, w: s["x"]
        combine = "max"
    want = jadvance.advance_push_sparse(
        jg, jids, jvalid, ecap, {k: jnp.asarray(a) for k, a in src.items()},
        jop, combine, jnp.asarray(out), direction=JDir.SCATTER)
    got = tadvance.advance_push_sparse(
        tg, tids, tvalid, ecap, {k: torch.from_numpy(a) for k, a in src.items()},
        top, combine, torch.from_numpy(out), direction=TDir.SCATTER)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the push changed something
    assert (got.numpy() != out).any()


@pytest.fixture(scope="module")
def wgraphs(request):
    """name -> (JAX graph, JAX EdgeArray, port graph, port EdgeArray) of a
    conftest graph with random weights, built once."""
    cache = {}

    def get(name):
        if name not in cache:
            ec = request.getfixturevalue(name).with_random_weights(seed=11)
            jhost, thost = [], []
            jg = jimport_graph(ec, _host_out=jhost)
            tg = timport_graph(ec, device="cpu", _host_out=thost)
            cache[name] = (
                jg, jbuild_edge_array(ec.weights, jg, jhost[0], jhost[1]),
                tg, tbuild_edge_array(ec.weights, tg, thost[0], thost[1]))
        return cache[name]
    return get


# frontiers of the weighted push: capacity an exact fit, half of the degree
# sum (edges past it drop), zero-degree vertices with invalid entries, empty
WEIGHTED_CASES = ["exact", "overflow", "zero-degree", "empty"]


@pytest.mark.parametrize("graph", ["small_rmat", "small_ru"])
@pytest.mark.parametrize("combine", ["min", "max"])
@pytest.mark.parametrize("case", WEIGHTED_CASES)
def test_advance_push_sparse_with_weights_matches_jax(wgraphs, graph, combine,
                                                      case):
    """SSSP's relaxation (f32 min of dist[src] + w into dist) and its max
    twin, bit for bit: each message is one f32 addition and min/max have one
    answer in any order."""
    jg, jea, tg, tea = wgraphs(graph)
    rng = np.random.default_rng(15)
    degs = np.asarray(jg.outgoing.degrees)
    mask = rng.random(jg.v_pad) < 0.1
    if case == "empty":
        mask[:] = False
    elif case == "zero-degree":
        zero = np.flatnonzero(degs[:jg.v] == 0)
        assert graph == "small_ru" or len(zero) > 0
        mask[zero[:20]] = True
    jf = jfrontier.from_mask(jg, jnp.asarray(mask), JDir.SCATTER)
    tf = tfrontier.from_mask(tg, torch.from_numpy(mask), TDir.SCATTER)
    cap = tcommon.next_pow2(max(int(tf.size), 8)) \
        * (2 if case == "zero-degree" else 1)
    jids, jvalid = jfrontier.compact_ids(jf, cap)
    tids, tvalid = tfrontier.compact_ids(tf, cap)
    deg_sum = int(tf.neighbours_count)
    ecap = max(deg_sum // 2 if case == "overflow" else deg_sum, 8)
    dist = rng.uniform(0, 300, jg.v_pad).astype(np.float32)
    dist[rng.random(jg.v_pad) < 0.3] = np.inf
    want = jadvance.advance_push_sparse(
        jg, jids, jvalid, ecap, {"d": jnp.asarray(dist)},
        lambda s, d, w: s["d"] + w, combine, jnp.asarray(dist),
        edge_values=jea.outgoing, direction=JDir.SCATTER)
    got = tadvance.advance_push_sparse(
        tg, tids, tvalid, ecap, {"d": torch.from_numpy(dist)},
        lambda s, d, w: s["d"] + w, combine, torch.from_numpy(dist),
        edge_values=tea.outgoing, direction=TDir.SCATTER)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() != dist).any() == (case not in ("empty",
                                                          "zero-degree")
                                           or (case == "zero-degree"
                                               and deg_sum > 0))


# frontiers of the constant push: capacity an exact fit, half of it (edges
# past it drop), zero-degree vertices with invalid padding entries, empty
CONST_CASES = ["exact", "overflow", "zero-degree", "empty"]
CONST_MSG = {"min": 5, "max": 7, "or": (1 << 20) | 3}


@pytest.mark.parametrize("graph", ["small_rmat", "small_ru"])
@pytest.mark.parametrize("op", ["min", "max", "or"])
@pytest.mark.parametrize("case", CONST_CASES)
def test_advance_push_sparse_const_matches_jax(graphs, graph, op, case):
    """advance_push_sparse_const (on the CPU: push_expand's plain version)
    against JAX's advance_push_sparse with the constant edge op (min, max;
    JAX has no int32 or-scatter) and against numpy (all three)."""
    _, jg, tg = graphs(graph)
    rng = np.random.default_rng(12)
    degs = np.asarray(jg.outgoing.degrees)
    mask = rng.random(jg.v_pad) < 0.1
    if case == "empty":
        mask[:] = False
    elif case == "zero-degree":
        zero = np.flatnonzero(degs[:jg.v] == 0)
        assert graph == "small_ru" or len(zero) > 0
        mask[zero[:20]] = True
    jf = jfrontier.from_mask(jg, jnp.asarray(mask), JDir.SCATTER)
    size = int(jf.size)
    cap = tcommon.next_pow2(max(size, 8)) * (2 if case == "zero-degree" else 1)
    jids, jvalid = jfrontier.compact_ids(jf, cap)
    deg_sum = int(jf.neighbours_count)
    ecap = max(deg_sum // 2 if case == "overflow" else deg_sum, 8)
    out = (np.where(rng.random(jg.v_pad) < 0.5, INT32_MAX,
                    rng.integers(1, 9, jg.v_pad)).astype(np.int32)
           if op == "min" else _i32(rng, jg.v_pad))
    msg = CONST_MSG[op]
    ids, valid = np.array(jids), np.array(jvalid)
    assert (~valid).any() or case not in ("zero-degree", "empty")
    got = tadvance.advance_push_sparse_const(
        tg, torch.from_numpy(ids), torch.from_numpy(valid), ecap, msg, op,
        torch.from_numpy(out), direction=TDir.SCATTER)
    assert got.dtype == torch.int32

    rp = np.asarray(jg.outgoing.row_ptr)
    ci = np.asarray(jg.outgoing.col_idx)
    dsts = np.concatenate([ci[rp[i]:rp[i + 1]] for i in ids[valid]]
                          + [np.zeros(0, np.int32)])[:ecap]
    want = out.copy()
    {"min": np.minimum, "max": np.maximum, "or": np.bitwise_or}[op].at(
        want, dsts, np.int32(msg))
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "empty":
        np.testing.assert_array_equal(got.numpy(), out)
    if op != "or":
        jwant = jadvance.advance_push_sparse(
            jg, jids, jvalid, ecap, {},
            lambda s, d, w: jnp.full((ecap, 1), msg, jnp.int32), op,
            jnp.asarray(out), direction=JDir.SCATTER)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jwant))


SCATTERS = [("add", "f32"), ("add", "i32"), ("min", "f32"), ("min", "i32"),
            ("max", "f32"), ("max", "i32"), ("any01", "i32"), ("or", "bool")]


@pytest.mark.parametrize("name,dtype", SCATTERS)
def test_scatter_at_matches_jax(name, dtype):
    """Duplicated indices and indices past the end (dropped)."""
    rng = np.random.default_rng(6)
    n, m = 64, 500
    idx = rng.integers(0, n + 16, m).astype(np.int32)
    if dtype == "f32":
        data = lambda k: (rng.integers(-50, 50, k) if name == "add"
                          else rng.standard_normal(k)).astype(np.float32)
    elif dtype == "bool":
        data = lambda k: rng.random(k) < 0.3
    elif name == "any01":
        data = lambda k: rng.integers(0, 2, k).astype(np.int32)
    else:
        data = lambda k: _i32(rng, k)
    target, vals = data(n), data(m)
    want = jmonoid.get(name).scatter_at(jnp.asarray(target), jnp.asarray(idx),
                                        jnp.asarray(vals), mode="drop")
    got = tmonoid.get(name).scatter_at(torch.from_numpy(target),
                                       torch.from_numpy(idx),
                                       torch.from_numpy(vals), mode="drop")
    assert got.numpy().dtype == np.asarray(want).dtype
    if name == "add" and dtype == "f32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_scatter_at_contract():
    t = torch.zeros(8, dtype=torch.int32)
    i = torch.tensor([0, 3, 3], dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        tmonoid.OR.scatter_at(t, i, torch.tensor([1, 2, 4], dtype=torch.int32))
    with pytest.raises(NotImplementedError):
        jmonoid.OR.scatter_at(jnp.zeros(8, jnp.int32), jnp.asarray(i.numpy()),
                              jnp.asarray([1, 2, 4], jnp.int32))
    with pytest.raises(ValueError):
        tmonoid.MAX.scatter_at(t, i, i, mode="clip")
    # the port drops negative indices too (JAX would wrap them; no caller
    # passes one)
    got = tmonoid.MAX.scatter_at(t, torch.tensor([-1, 2, 8], dtype=torch.int32),
                                 torch.tensor([5, 6, 7], dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), [0, 0, 6, 0, 0, 0, 0, 0])
    assert int(t.abs().sum()) == 0          # the target is not changed


V = 1 << 12


@pytest.mark.parametrize("ecap", [0, 1 << 10, 1 << 14])
def test_scatter_combine_ref_is_the_tpu_kernels_function(ecap):
    """op="or", msg=1 against _kern (numpy: out[d] |= 1 for d < V) and
    against a_scatter's body (.at[d].max(1, mode="drop")), from a nonzero
    target; a quarter of the destinations past V."""
    rng = np.random.default_rng(7)
    d = rng.integers(0, V + V // 3, ecap).astype(np.int32)
    out0 = rng.integers(0, 4, V).astype(np.int32)
    want = out0.copy()
    for x in d:
        if x < V:
            want[x] |= 1
    got = sc.scatter_combine_ref(torch.from_numpy(out0), torch.from_numpy(d),
                                 1, "or")
    np.testing.assert_array_equal(got.numpy(), want)
    zeros = np.zeros(V, np.int32)
    got0 = sc.scatter_combine_ref(torch.from_numpy(zeros), torch.from_numpy(d),
                                  1, "or")
    xla = jnp.asarray(zeros).at[jnp.asarray(d)].max(1, mode="drop")
    np.testing.assert_array_equal(got0.numpy(), np.asarray(xla))


@pytest.mark.parametrize("op", ["min", "max", "or", "add"])
def test_scatter_combine_ref_matches_numpy(op):
    """Random int32 messages over the full range (bit 31 set for or; sums
    wrap modulo 2^32 for add), duplicates, negative and too-large indices
    dropped."""
    rng = np.random.default_rng(8)
    n, m = 300, 4000
    idx = rng.integers(-20, n + 20, m).astype(np.int32)
    msg, out = _i32(rng, m), _i32(rng, n)
    keep = (idx >= 0) & (idx < n)
    want = out.copy()
    {"min": np.minimum, "max": np.maximum, "or": np.bitwise_or,
     "add": np.add}[op].at(want, idx[keep], msg[keep])
    got = sc.scatter_combine(torch.from_numpy(out), torch.from_numpy(idx),
                             torch.from_numpy(msg), op)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        sc.scatter_combine(torch.from_numpy(out), torch.from_numpy(idx),
                           torch.from_numpy(msg), "xor")


@pytest.mark.parametrize("op", ["min", "max"])
def test_scatter_combine_ref_f32_matches_numpy(op):
    """f32 messages with duplicates, +-inf entries and dropped indices, and
    one constant message for all, against numpy's unbuffered min/max."""
    rng = np.random.default_rng(9)
    n, m = 300, 4000
    idx = rng.integers(-20, n + 20, m).astype(np.int32)
    msg = rng.standard_normal(m).astype(np.float32) * 50
    msg[::97] = np.inf
    msg[5::101] = -np.inf
    out = rng.standard_normal(n).astype(np.float32) * 50
    out[::7] = np.inf if op == "min" else -np.inf
    keep = (idx >= 0) & (idx < n)
    ufunc = {"min": np.minimum, "max": np.maximum}[op]
    want = out.copy()
    ufunc.at(want, idx[keep], msg[keep])
    got = sc.scatter_combine(torch.from_numpy(out), torch.from_numpy(idx),
                             torch.from_numpy(msg), op)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    want = out.copy()
    ufunc.at(want, idx[keep], np.float32(1.5))
    got = sc.scatter_combine_ref(torch.from_numpy(out), torch.from_numpy(idx),
                                 1.5, op)
    np.testing.assert_array_equal(got.numpy(), want)
    # Monoid.scatter_at takes the same path
    got = tmonoid.get(op).scatter_at(torch.from_numpy(out),
                                     torch.from_numpy(idx),
                                     torch.from_numpy(msg))
    ufunc.at(out, idx[keep], msg[keep])
    np.testing.assert_array_equal(got.numpy(), out)


def test_cpu_run_launches_no_kernel(graphs):
    ec, _, tg = graphs("small_ru")
    sc.scatter_combine.launches = 0
    rg.route_gather_finish.launches = 0
    pe.push_expand.launches = 0
    trace = []
    tbfs.vgl_bfs_device(tg, tcommon.select_random_source(ec, seed=1),
                        id_cap=64, edge_cap=256, trace=trace)
    assert any(t[0] == "td" for t in trace) and any(t[0] == "bu" for t in trace)
    assert sc.scatter_combine.launches == 0
    assert rg.route_gather_finish.launches == 0
    assert pe.push_expand.launches == 0
