"""PyTorch port, graph import on the target device: graph/build_torch's
torch build of a direction equals graph/build.py's numpy build field for
field (run here on the CPU), import_graph equals from_host fed by the numpy
builds, edge values laid out from the device records equal those laid out
from the host CSRs, the advance route keeps its bytes, and graphs past the
int32 extents are refused."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorgraphlibrary_tpu_torch.config import DEFAULT_CONFIG
from vectorgraphlibrary_tpu_torch.graph import build_torch
from vectorgraphlibrary_tpu_torch.graph.build import build_directed_csr
from vectorgraphlibrary_tpu_torch.graph.device import (_i32, from_host,
                                                       import_graph)
from vectorgraphlibrary_tpu_torch.graph.edges import \
    build_edge_array_from_host
from vectorgraphlibrary_tpu_torch.io import generation
from vectorgraphlibrary_tpu_torch.io.edges_container import EdgesContainer

T = DEFAULT_CONFIG.huge_degree_threshold
CW = DEFAULT_CONFIG.huge_row_chunk


def _star(v, degrees, seed=0):
    """Vertex i (i < len(degrees)) has out-degree degrees[i] to random
    targets; then random edges among the rest."""
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(len(degrees)), degrees)
    rest = 3 * v
    src = np.concatenate([src, rng.integers(len(degrees), v, rest)])
    dst = rng.integers(0, v, len(src))
    perm = rng.permutation(len(src))
    return EdgesContainer(src[perm], dst[perm], v)


def _graph(name: str) -> EdgesContainer:
    rng = np.random.default_rng(7)
    if name == "no_edges":
        return EdgesContainer(np.zeros(0, np.int32), np.zeros(0, np.int32), 5)
    if name == "one_vertex":
        return EdgesContainer(np.zeros(3, np.int32), np.zeros(3, np.int32), 1)
    if name == "isolated":
        # ids 0..99 of 2,000 carry every edge
        return EdgesContainer(rng.integers(0, 100, 700),
                              rng.integers(0, 100, 700), 2000)
    if name == "loops_and_repeats":
        src = rng.integers(0, 300, 1500)
        dst = rng.integers(0, 300, 1500)
        src[:200] = dst[:200]                       # self-loops
        return EdgesContainer(np.concatenate([src, src[:400]]),
                              np.concatenate([dst, dst[:400]]), 300)
    if name == "at_threshold":
        # rows of degree T (an ELL bucket's widest) and T + 1 (huge)
        return _star(1500, [T + 1, T, T + 1, T, T - 1])
    if name == "chunk_boundary":
        # huge rows that end exactly on a chunk, and one slot past it
        return _star(1200, [2 * CW, CW, 3 * CW, CW + 1, 2 * CW - 1])
    if name == "under_pow2":
        return EdgesContainer(rng.integers(0, 2047, 8000),
                              rng.integers(0, 2047, 8000), 2047)
    if name == "over_pow2":
        return EdgesContainer(rng.integers(0, 2049, 8000),
                              rng.integers(0, 2049, 8000), 2049)
    if name == "under_floor":
        return EdgesContainer(rng.integers(0, 600, 3000),
                              rng.integers(0, 600, 3000), 600)
    if name == "rmat":
        return generation.rmat(scale=10, avg_degree=8, seed=3)
    raise KeyError(name)


GRAPHS = ["no_edges", "one_vertex", "isolated", "loops_and_repeats",
          "at_threshold", "chunk_boundary", "under_pow2", "over_pow2",
          "under_floor", "rmat"]


def _ends(ec, direction):
    return ((ec.src_ids, ec.dst_ids) if direction == "out"
            else (ec.dst_ids, ec.src_ids))


def _np(t):
    return t.cpu().numpy()


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("direction", ["out", "in"])
def test_torch_build_equals_numpy_build(name, direction):
    ec = _graph(name)
    src, dst = _ends(ec, direction)
    h = build_directed_csr(src, dst, ec.vertices_count)
    d = build_torch.build_directed_csr_torch(src, dst, ec.vertices_count,
                                             device="cpu")
    g = d.graph
    assert (g.v, g.v_pad, g.e, g.e_pad) == (
        h.vertices_count, h.vertices_pad, h.edges_count, h.edges_pad)
    for f in ("row_ptr", "col_idx", "degrees", "sorted_to_orig",
              "orig_to_sorted"):
        got = getattr(g, f)
        assert got.dtype == torch.int32, f
        np.testing.assert_array_equal(_np(got), getattr(h, f), err_msg=f)
    e = h.edges_count
    assert d.edge_perm.shape == (h.edges_pad,)
    np.testing.assert_array_equal(_np(d.edge_perm[:e]), h.edge_perm[:e])
    assert len(g.buckets) == len(h.buckets)
    for tb, hb in zip(g.buckets, h.buckets):
        assert (tb.width, tb.row_start, tb.rows, tb.rows_pad) == \
            (hb.width, hb.row_start, hb.rows, hb.rows_pad)
        assert tb.adj.dtype == torch.int32
        np.testing.assert_array_equal(_np(tb.adj), hb.adj)
    assert (g.huge is None) == (h.huge is None)
    if h.huge is not None:
        hh, th = h.huge, g.huge
        assert (th.chunk_w, th.n_rows, th.n_chunks, th.n_chunks_pad) == \
            (hh.chunk_w, hh.n_rows, hh.n_chunks, hh.n_chunks_pad)
        np.testing.assert_array_equal(_np(th.adj), hh.adj)
        np.testing.assert_array_equal(_np(th.seg_ids), hh.seg_ids)
        assert th.seg_lengths.dtype == torch.int64
        np.testing.assert_array_equal(
            _np(th.seg_lengths),
            np.bincount(hh.seg_ids, minlength=hh.n_rows + 1))
    if direction == "out" and name == "at_threshold":
        assert g.huge.n_rows == 2 and g.buckets[0].width == T
    if direction == "out" and name == "chunk_boundary":
        assert (g.huge.n_rows, g.huge.n_chunks) == (5, 2 + 1 + 3 + 2 + 2)


@pytest.mark.parametrize("name", GRAPHS)
def test_host_csr_of_the_device_build_is_the_numpy_build(name):
    """host_csr rebuilds the host CSR, the tiles' edge slots (eidx)
    included, from the device result: what the advance route reads."""
    ec = _graph(name)
    for direction in ("out", "in"):
        src, dst = _ends(ec, direction)
        want = build_directed_csr(src, dst, ec.vertices_count)
        got = build_torch.host_csr(build_torch.build_directed_csr_torch(
            src, dst, ec.vertices_count, device="cpu"))
        for f in ("row_ptr", "col_idx", "degrees", "edge_perm",
                  "sorted_to_orig", "orig_to_sorted"):
            assert getattr(got, f).dtype == getattr(want, f).dtype, f
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        for a, b in zip(got.buckets, want.buckets):
            np.testing.assert_array_equal(a.adj, b.adj)
            np.testing.assert_array_equal(a.eidx, b.eidx)
        if want.huge is not None:
            for f in ("adj", "eidx", "seg_ids"):
                np.testing.assert_array_equal(getattr(got.huge, f),
                                              getattr(want.huge, f))


def _fields(obj, prefix=""):
    """A port graph as {path: tensor or scalar}."""
    out = {}
    if isinstance(obj, torch.Tensor):
        out[prefix] = obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            out.update(_fields(getattr(obj, f.name), f"{prefix}.{f.name}"))
    elif isinstance(obj, (tuple, list)):
        for i, x in enumerate(obj):
            out.update(_fields(x, f"{prefix}[{i}]"))
    else:
        out[prefix] = obj
    return out


def _numpy_import(ec, build_route):
    hosts = [build_directed_csr(*_ends(ec, d), ec.vertices_count)
             for d in ("out", "in")]
    g = from_host(hosts[0], hosts[1], ec.src_ids == ec.dst_ids,
                  ec.vertices_count, ec.edges_count, device="cpu",
                  build_route=build_route)
    return g, hosts


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("build_route", [False, True])
def test_import_graph_equals_from_host_of_numpy_builds(name, build_route):
    """Every VGLGraph field, the advance route's bytes included where it
    is built."""
    ec = _graph(name)
    want, _ = _numpy_import(ec, build_route)
    got = import_graph(ec, device="cpu", build_route=build_route)
    assert (got.advance_route is None) == (not build_route)
    a, b = _fields(want), _fields(got)
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert a[k].dtype == b[k].dtype, k
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("name", ["loops_and_repeats", "chunk_boundary",
                                  "rmat"])
@pytest.mark.parametrize("pad_value", [0, -1])
def test_edge_values_from_device_records_equal_host_csrs(name, pad_value):
    ec = _graph(name)
    want_g, hosts = _numpy_import(ec, False)
    records = []
    got_g = import_graph(ec, device="cpu", _host_out=records,
                         build_route=False)
    assert all(isinstance(r.edge_perm, torch.Tensor) for r in records)
    for values in (np.random.default_rng(1).uniform(
                       1, 100, ec.edges_count).astype(np.float32),
                   np.arange(ec.edges_count, dtype=np.int32)):
        want = build_edge_array_from_host(values, want_g, hosts[0], hosts[1],
                                          pad_value=pad_value)
        got = build_edge_array_from_host(values, got_g, records[0],
                                         records[1], pad_value=pad_value)
        for d in ("outgoing", "incoming"):
            a, b = getattr(want, d).flat, getattr(got, d).flat
            assert a.dtype == b.dtype
            assert torch.equal(a, b), d


def test_edge_values_refuse_another_graphs_records():
    records = []
    import_graph(_graph("rmat"), device="cpu", _host_out=records,
                 build_route=False)
    other = import_graph(_graph("over_pow2"), device="cpu",
                         build_route=False)
    with pytest.raises(ValueError):
        build_edge_array_from_host(np.ones(other.e, np.float32), other,
                                   records[0], records[1])


def test_import_keeps_a_device_build_span_per_direction():
    from vectorgraphlibrary_tpu_torch.runtime import profiling
    import_graph(_graph("rmat"), device="cpu", build_route=False)
    kept = profiling.kept_spans()
    (_, lo, hi), = [k for k in kept if k[0] == "vgl.import"][-1:]
    inside = [n for n, s, e in kept if lo <= s <= e <= hi]
    assert inside.count("vgl.import.csr.device") == 2
    assert inside.count("vgl.import.csr") == 2


@pytest.mark.parametrize("arcs", [np.int64(2**31), 2**31, 2**33])
def test_the_int32_extent_is_refused(arcs):
    """2^31 arcs or more cannot be held by an int32 CSR: the device build
    refuses them before allocating, and the host upload's cast refuses a
    row_ptr past int32 where it would wrap."""
    with pytest.raises(ValueError, match="2\\^31 arcs"):
        build_torch.check_extent(arcs, 1024)
    with pytest.raises(ValueError, match="2\\^31"):
        _i32(np.array([0, arcs], np.int64), "cpu")
    build_torch.check_extent(2**31 - 1, 1024)
    with pytest.raises(ValueError, match="vertex ids"):
        build_torch.check_extent(8, 2**31)
