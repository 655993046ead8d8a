"""PyTorch port, transitive closure and triangle counting: reachability by
Purdom's condensation and by per-source BFS against the JAX package's (bool
matrices equal, and equal to seq_reachability) on RMAT-7, RMAT-10, a path
graph and a cycle (no cross-component edge); triangle counts against the
JAX package's and both oracles with block_bits=256 (several blocks) and the
default; the bitmap build against the JAX package's; Monoid.scatter_at("add")
against JAX's .at[].add; the AND-popcount kernel's plain version against
numpy's bit count, also on runs of one u across chunks and shuffled pairs;
the count's trace against the presence filter in numpy; and the app's CLI
contract (-purdoms, -bfs-based)."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorgraphlibrary_tpu.graph.device import import_graph as jimport_graph
from vectorgraphlibrary_tpu.io import generation
from vectorgraphlibrary_tpu.io.edges_container import EdgesContainer
from vectorgraphlibrary_tpu.models import tc as jtc
from vectorgraphlibrary_tpu.ops import monoid as jmonoid

from vectorgraphlibrary_tpu_torch.graph.device import import_graph as timport_graph
from vectorgraphlibrary_tpu_torch.models import tc as ttc
from vectorgraphlibrary_tpu_torch.ops import monoid as tmonoid
from vectorgraphlibrary_tpu_torch.ops.cuda import and_popcount as ap
from vectorgraphlibrary_tpu_torch.ops.cuda import pull_reduce as pl
from vectorgraphlibrary_tpu_torch.ops.cuda import push_expand as pe
from vectorgraphlibrary_tpu_torch.ops.cuda import route_gather as rg
from vectorgraphlibrary_tpu_torch.ops.cuda import scatter_combine as sc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# graph -> sources (tests/test_algorithms3.py uses [1, 5, 9] and [2, 7] on
# RMAT-7)
REACH = {"tiny": [1, 5, 9], "small_rmat": [0, 17, 300], "path": [0, 30, 61],
         "cycle": [0, 4]}
# (graph, block_bits): None is the default block, 256 several blocks
TRIANGLES = [("tiny", None), ("tiny", 64), ("small_rmat", 256),
             ("small_rmat", None), ("small_ru", 256), ("selfloops", 256)]


def _path_graph():
    """tests/test_algorithms.py's path of 60 vertices plus a triangle."""
    n = 60
    src = np.concatenate([np.arange(n - 1), [n, n + 1, n + 2]]).astype(np.int32)
    dst = np.concatenate([np.arange(1, n), [n + 1, n + 2, n]]).astype(np.int32)
    return EdgesContainer(src, dst, n + 3)


def _selfloop_graph():
    """tests/test_torch_host.py's random graph with 50 self-loops."""
    rng = np.random.default_rng(0)
    v, e = 900, 9000
    src = rng.integers(0, v, e).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    src[:50] = dst[:50]
    return EdgesContainer(src, dst, v)


def _cycle():
    """One strongly connected cycle of 12 vertices: the condensation has no
    edge."""
    src = np.arange(12, dtype=np.int32)
    return EdgesContainer(src, (src + 1) % 12, 12)


@pytest.fixture(scope="module")
def graphs(request):
    cache = {}

    def get(name):
        if name not in cache:
            ec = {"path": _path_graph, "selfloops": _selfloop_graph,
                  "cycle": _cycle,
                  "tiny": lambda: generation.rmat(scale=7, avg_degree=4,
                                                  seed=17)}.get(name)
            ec = ec() if ec else request.getfixturevalue(name)
            cache[name] = (ec, jimport_graph(ec), timport_graph(ec, device="cpu"))
        return cache[name]
    return get


@pytest.mark.parametrize("graph", list(REACH))
def test_purdom_reachability_matches_jax_and_oracle(graphs, graph):
    ec, jg, tg = graphs(graph)
    sources = np.asarray(REACH[graph])
    got = ttc.reachability(ec, tg, sources)
    assert got.dtype == bool and got.shape == (len(sources), tg.v)
    np.testing.assert_array_equal(got, jtc.reachability(ec, jg, sources))
    np.testing.assert_array_equal(got, ttc.seq_reachability(ec, sources))
    dense, cec = ttc.vgl_purdoms(ec, tg)
    jdense, jcec = jtc.vgl_purdoms(ec, jg)
    np.testing.assert_array_equal(dense, jdense)
    np.testing.assert_array_equal(cec.src_ids, jcec.src_ids)
    np.testing.assert_array_equal(cec.dst_ids, jcec.dst_ids)
    assert (cec.edges_count == 0) == (graph == "cycle")


@pytest.mark.parametrize("graph", list(REACH))
def test_bfs_based_reachability_matches_jax(graphs, graph):
    ec, jg, tg = graphs(graph)
    sources = np.asarray(REACH[graph][:2])
    got = ttc.vgl_bfs_based_reachability(tg, sources)
    np.testing.assert_array_equal(
        got, jtc.vgl_bfs_based_reachability(jg, sources))
    np.testing.assert_array_equal(got, ttc.seq_reachability(ec, sources))


@pytest.mark.parametrize("graph,block_bits", TRIANGLES)
def test_triangle_count_matches_jax_and_oracles(graphs, graph, block_bits):
    ec, _, _ = graphs(graph)
    trace = []
    got = ttc.vgl_triangle_count(ec, block_bits=block_bits, device="cpu",
                                 trace=trace)
    assert isinstance(got, int)
    assert got == jtc.vgl_triangle_count(ec, block_bits=block_bits)
    assert got == ttc.seq_triangle_count(ec)
    u, v = ttc._oriented_simple_edges(ec)
    assert got == ttc.seq_oriented_triangle_count(u, v, ec.vertices_count)
    blocks = -(-ec.vertices_count // (block_bits or ec.vertices_count))
    assert len(trace) == blocks if block_bits else len(trace) == 1
    if block_bits:
        assert blocks > 1


def test_triangle_count_small_chunks_and_precomputed_orientation(graphs):
    ec, _, _ = graphs("small_rmat")
    oriented = ttc._oriented_simple_edges(ec)
    want = ttc.seq_triangle_count(ec)
    assert ttc.vgl_triangle_count(ec, block_bits=256, edge_chunk=100,
                                  _oriented=oriented, device="cpu") == want


@pytest.mark.parametrize("fault", ["swapped", "reversed", "repeat"])
def test_triangle_count_refuses_unsorted_orientation(graphs, fault):
    """A precomputed orientation out of (u, v) order, or with an edge twice,
    is refused on the host before anything reaches the device: the card's
    sorted bitmap build does not check the order."""
    ec, _, _ = graphs("small_rmat")
    u_e, v_e = ttc._oriented_simple_edges(ec)
    if fault == "swapped":
        i = len(u_e) // 2
        order = np.arange(len(u_e))
        order[[i, i + 1]] = order[[i + 1, i]]
        u_e, v_e = u_e[order], v_e[order]
    elif fault == "reversed":
        u_e, v_e = u_e[::-1], v_e[::-1]
    else:
        u_e, v_e = np.insert(u_e, 5, u_e[5]), np.insert(v_e, 5, v_e[5])
    with pytest.raises(ValueError, match="sorted by u, then v"):
        ttc.vgl_triangle_count(ec, block_bits=256, _oriented=(u_e, v_e),
                               device="cpu")


def test_triangle_count_without_edges():
    ec = EdgesContainer(np.array([3, 4], np.int32), np.array([3, 4], np.int32),
                        8)
    assert ttc.vgl_triangle_count(ec, device="cpu") == 0


@pytest.mark.parametrize("graph,block_bits", [("tiny", 64), ("small_rmat", 256)])
def test_build_bits_matches_jax(graphs, graph, block_bits):
    ec, _, _ = graphs(graph)
    v = ec.vertices_count
    u_e, v_e = ttc._oriented_simple_edges(ec)
    m = v_e < block_bits
    words = block_bits // 32
    got = ttc._tc_build_bits(torch.from_numpy(u_e[m]),
                             torch.from_numpy(v_e[m]), v, words)
    want = jtc._tc_build_bits(jnp.asarray(u_e[m]), jnp.asarray(v_e[m]), v,
                              words, v)
    assert got.shape == (v + 1, words) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got[v].any()


@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("case", ["uniform", "duplicates", "dropped", "wrap"])
def test_scatter_at_add_matches_jax(case, dtype):
    rng = np.random.default_rng(4)
    n_out, n = 64, 1000
    idx = rng.integers(0, 5 if case == "duplicates" else n_out, n)
    if case == "dropped":
        idx[::3] = n_out + 2
    if dtype == "int32":
        hi = 2**31 - 1 if case == "wrap" else 1000
        vals = rng.integers(-hi, hi, n).astype(np.int32)
        target = rng.integers(-1000, 1000, n_out).astype(np.int32)
    else:
        vals = rng.integers(-8, 8, n).astype(np.float32)   # exact sums
        target = rng.integers(-8, 8, n_out).astype(np.float32)
    got = tmonoid.ADD.scatter_at(torch.from_numpy(target),
                                 torch.from_numpy(idx.astype(np.int32)),
                                 torch.from_numpy(vals))
    want = jmonoid.get("add").scatter_at(jnp.asarray(target),
                                         jnp.asarray(idx.astype(np.int32)),
                                         jnp.asarray(vals))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# (rows, words, edges, chunk): a ragged last chunk, one chunk, chunks of one
# edge, the main path's word count, an empty edge list
POPCOUNT = [(50, 7, 1000, 128), (50, 33, 100, 1000), (9, 1, 17, 1),
            (300, 512, 300, 64), (10, 4, 0, 16)]


@pytest.mark.parametrize("rows,words,n,chunk", POPCOUNT)
def test_and_popcount_ref_matches_numpy(rows, words, n, chunk):
    rng = np.random.default_rng(rows + words)
    bits = rng.integers(-2**31, 2**31, (rows, words), dtype=np.int64) \
        .astype(np.int32)
    bits[0] = -1                       # every bit, bit 31 included
    u = rng.integers(0, rows, n).astype(np.int32)
    v = rng.integers(0, rows, n).astype(np.int32)
    ap.and_popcount.launches = 0
    got = ap.and_popcount(torch.from_numpy(bits), torch.from_numpy(u),
                          torch.from_numpy(v), chunk)
    assert ap.and_popcount.launches == 0
    assert got.dtype == torch.int32 and got.shape == (-(-n // chunk),)
    b = bits.view(np.uint32)
    want = [int(np.bitwise_count(b[u[c:c + chunk]] & b[v[c:c + chunk]]).sum())
            for c in range(0, n, chunk)]
    assert got.tolist() == want
    np.testing.assert_array_equal(
        ap.popcount32(torch.from_numpy(bits)).numpy(), np.bitwise_count(b))


# (words, pairs, chunk): pairs sorted by u in runs that chunks of 100 and 7
# cut, hub rows with every word non-zero, words of 1, 8 and 512
RUNS = [(1, 3000, 100), (8, 3000, 7), (512, 2000, 100)]


@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("words,n,chunk", RUNS)
def test_and_popcount_ref_matches_numpy_on_runs(words, n, chunk, order):
    """The kernel's cases on the card: runs of one u across chunk
    boundaries, hub rows, and the same pairs shuffled."""
    rng = np.random.default_rng(words + n)
    rows = 257
    bits = rng.integers(-2**31, 2**31, (rows, words), dtype=np.int64)
    bits[rng.random((rows, words)) < 0.9] = 0
    bits[:4] = rng.integers(1, 2**31, (4, words))
    bits = bits.astype(np.int32)
    bits[0] = -1
    u = rng.integers(0, rows, n)
    u[:n // 5] = rng.integers(0, 4, n // 5)
    u = np.sort(u).astype(np.int32)
    v = rng.integers(0, rows, n).astype(np.int32)
    if order == "shuffled":
        perm = rng.permutation(n)
        u, v = u[perm], v[perm]
    else:       # some run of one u straddles a chunk boundary
        assert (u[chunk - 1:-1:chunk] == u[chunk::chunk]).any()
    got = ap.and_popcount(torch.from_numpy(bits), torch.from_numpy(u),
                          torch.from_numpy(v), chunk)
    b = bits.view(np.uint32)
    want = [int(np.bitwise_count(b[u[c:c + chunk]] & b[v[c:c + chunk]]).sum())
            for c in range(0, n, chunk)]
    assert got.tolist() == want


def _numpy_filter(u_e, v_e, v, c0, block_bits):
    """The presence filter as numpy on the host, as the triangle count ran
    it before it moved to the device: (edges built, edges counted)."""
    m = (v_e >= c0) & (v_e < c0 + block_bits)
    pres = np.zeros(v + 1, bool)
    pres[u_e[m]] = True
    em = pres[u_e] & pres[v_e]
    return int(m.sum()), int(em.sum())


@pytest.mark.parametrize("graph,block_bits", [("tiny", 64),
                                              ("small_rmat", 256),
                                              ("selfloops", 256)])
def test_triangle_count_trace_matches_host_filter(graphs, graph, block_bits):
    ec, _, _ = graphs(graph)
    trace = []
    ttc.vgl_triangle_count(ec, block_bits=block_bits, device="cpu",
                           trace=trace)
    u_e, v_e = ttc._oriented_simple_edges(ec)
    v = ec.vertices_count
    assert len(trace) == -(-v // block_bits)
    for c0, t in zip(range(0, v, block_bits), trace):
        built, counted = _numpy_filter(u_e, v_e, v, c0, block_bits)
        if t is None:
            assert counted == 0
            continue
        assert len(t) == 5 and t[:3] == (c0, built, counted)
        assert t[3] >= 0 and t[4] >= 0


def test_and_popcount_rejects_what_it_does_not_take():
    bits = torch.zeros(4, 8, dtype=torch.int32)
    idx = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(TypeError):
        ap.and_popcount(bits.long(), idx, idx, 4)
    with pytest.raises(TypeError):
        ap.and_popcount(bits, idx.long(), idx, 4)
    with pytest.raises(TypeError):
        ap.and_popcount(bits, idx, idx[:2], 4)
    with pytest.raises(ValueError):
        ap.and_popcount(bits, idx, idx, 0)


def test_tc_launches_no_kernel_on_the_cpu(graphs):
    ec, _, tg = graphs("tiny")
    kernels = (pl.pull_reduce, rg.route_gather_finish, pe.push_expand,
               sc.scatter_combine, ap.and_popcount)
    for k in kernels:
        k.launches = 0
    ttc.reachability(ec, tg, np.asarray([1]))
    ttc.vgl_triangle_count(ec, block_bits=64, device="cpu")
    assert all(k.launches == 0 for k in kernels)


@pytest.mark.parametrize("flag", ["default", "-purdoms", "-bfs-based"])
def test_app_cli_contract(flag):
    args = [] if flag == "default" else [flag]
    out = subprocess.run(
        [sys.executable, "-m", "vectorgraphlibrary_tpu_torch.apps.tc", "-s",
         "10", "-e", "8", "-it", "2", "-check", "-dev", "cpu", *args],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "AVG_PERF:" in out.stdout
    assert out.stdout.count("error count: 0") == 2
