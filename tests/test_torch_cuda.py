"""PyTorch port on the card: the route-gather, CSR pull (with edge weights,
and its segment-reduce entry), scatter-combine (int32 and f32, in place,
and the sorted build),
expand-and-scatter, lane-shuffle, AND-popcount and feature-row pull kernels
against their plain versions (bit for bit, but f32 sums at rtol 1e-5:
another order), their launch counts, their argument checks, and the slices
(PageRank, BFS, loading a saved graph, SSSP, SSWP, HITS, CC, SCC, coloring,
label propagation, random walks, reachability, triangle count, GraphSAGE,
the general advance, max-flow) on CUDA against the same slices on the
CPU, and the measurement runtime (DeviceTimer against an event pair, the
per-primitive pass within the card's bandwidth, the memory profile). Every
test
here needs an NVIDIA GPU and skips
without one. The file needs no JAX (the card's host has none), so on the card
run it without tests/conftest.py, which imports jax:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorgraphlibrary_tpu_torch.graph.device import import_graph
from vectorgraphlibrary_tpu_torch.graph.persistence import (
    load_graph_from_binary_file, save_graph_to_binary_file)
from vectorgraphlibrary_tpu_torch.io import generation
from vectorgraphlibrary_tpu_torch.graph.vertices import as_original_numpy
from vectorgraphlibrary_tpu_torch.graph.edges import build_edge_array_from_host
from vectorgraphlibrary_tpu_torch.models import bfs, cc, common, hits, pr, sssp, sswp
from vectorgraphlibrary_tpu_torch.models import coloring, lp, rw, scc, tc
from vectorgraphlibrary_tpu_torch.graph import frontier
from vectorgraphlibrary_tpu_torch.ops import advance, monoid
from vectorgraphlibrary_tpu_torch.ops.cuda import and_popcount as ap
from vectorgraphlibrary_tpu_torch.ops.cuda import lane_shuffle as ls
from vectorgraphlibrary_tpu_torch.ops.cuda import pull_reduce as pl
from vectorgraphlibrary_tpu_torch.ops.cuda import push_expand as pe
from vectorgraphlibrary_tpu_torch.ops.cuda import route_gather as rg
from vectorgraphlibrary_tpu_torch.ops.cuda import scatter_combine as sc
from vectorgraphlibrary_tpu_torch.ops.route import (FinishSpec, apply_route,
                                                    make_route_plan)
from vectorgraphlibrary_tpu_torch.utils.verify import verify_results

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["f32", "i32", "i8"])
@pytest.mark.parametrize("wop", [None, "add", "min", "max", "mul"])
def test_kernel_equals_plain_version(cuda, dtype, wop):
    rng = np.random.default_rng(1)
    n = 1 << 16
    idx = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(cuda)
    flags = torch.from_numpy(rng.integers(0, 4, n).astype(np.uint8)).to(cuda)

    def data():
        if dtype == "f32":
            return rng.standard_normal(n).astype(np.float32)
        if dtype == "i32":
            return rng.integers(-2**31, 2**31 - 1, n,
                                dtype=np.int64).astype(np.int32)
        return rng.integers(-128, 128, n).astype(np.int8)
    x = torch.from_numpy(data()).to(cuda)
    w = None if wop is None else torch.from_numpy(data()).to(cuda)
    for kw in ({}, dict(flags=flags, exclude_self_loops=True, ident=-3),
               dict(flags=flags, exclude_self_loops=False, ident=5)):
        if wop is not None:
            kw = dict(kw, weight_op=wop, weights=w)
        before = rg.route_gather_finish.launches
        got = rg.route_gather_finish(x, idx, **kw)
        torch.cuda.synchronize()
        assert rg.route_gather_finish.launches == before + 1
        want = rg.route_gather_finish_ref(x, idx, **kw)
        if dtype == "f32":
            got, want = got.view(torch.int32), want.view(torch.int32)
        assert torch.equal(got, want)


@pytest.mark.parametrize("n,offset", [(1001, 0), (4099, 1), (1 << 12, 3),
                                      (1 << 12, 4)])
def test_kernel_tail_and_offset_views_equal_plain_version(cuda, n, offset):
    """Routes whose length is not a multiple of 4, and index, flag and
    weight views at an offset (not 16-byte aligned): equal to the plain
    version."""
    rng = np.random.default_rng(n + offset)

    def view(a):
        return torch.from_numpy(a).to(cuda)[offset:]
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda)
    idx = view(rng.integers(0, n, n + offset).astype(np.int32))
    flags = view(rng.integers(0, 4, n + offset).astype(np.uint8))
    w = view(rng.standard_normal(n + offset).astype(np.float32))
    for kw in ({}, dict(flags=flags, exclude_self_loops=True, ident=-1.5),
               dict(flags=flags, weights=w, weight_op="min", ident=2.0)):
        got = rg.route_gather_finish(x, idx, **kw)
        want = rg.route_gather_finish_ref(x, idx, **kw)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# every tail of the vector items (V = 4 for 4-byte values, 16 for bytes),
# one wave and several
ROUTE_NS = [1, 3, 15, 16, 17, 4095, 1 << 18, (1 << 20) + 5]


def _route_data(rng, dtype, k):
    """k seeded values of dtype; f32 with NaNs (one canonical NaN, so a
    NaN's bits do not depend on which operand min/max return), infinities
    and signed zeros."""
    if dtype == "f32":
        a = rng.standard_normal(k).astype(np.float32)
        special = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0], np.float32)
        pick = rng.random(k) < 0.1
        a[pick] = special[rng.integers(0, 5, int(pick.sum()))]
        return a
    if dtype == "i32":
        return rng.integers(-2**31, 2**31 - 1, k, dtype=np.int64).astype(
            np.int32)
    return rng.integers(-128, 128, k).astype(np.int8)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", ROUTE_NS)
@pytest.mark.parametrize("dtype", ["f32", "i32", "i8"])
def test_route_gather_every_entry_tail_and_view(cuda, dtype, n, offset):
    """Every entry (the finish entries of each type, and b4 and b1 without
    a finish), every weight op with and without flags and
    exclude_self_loops, at every tail of the vector items; x, idx, flags
    and weights as views one element past a 16-byte boundary (offset 1),
    which the kernel reads by words or bytes. Bit-equal to the plain
    version, one launch counted per call."""
    rng = np.random.default_rng(8 * n + offset)
    m = n + 7                                  # x longer than the route

    def view(a):
        return torch.from_numpy(a).to(cuda)[offset:]
    x = view(_route_data(rng, dtype, m + offset))
    idx = view(rng.integers(0, m, n + offset).astype(np.int32))
    flags = view(rng.integers(0, 4, n + offset).astype(np.uint8))
    w = view(_route_data(rng, dtype, n + offset))
    ident = -2.5 if dtype == "f32" else -3
    cases = [{}]
    for excl in (False, True):
        cases.append(dict(flags=flags, exclude_self_loops=excl, ident=ident))
    for op in ("add", "min", "max", "mul"):
        cases.append(dict(weights=w, weight_op=op))
        for excl in (False, True):
            cases.append(dict(flags=flags, exclude_self_loops=excl,
                              ident=ident, weights=w, weight_op=op))
    for kw in cases:
        before = rg.route_gather_finish.launches
        got = rg.route_gather_finish(x, idx, **kw)
        torch.cuda.synchronize()
        assert rg.route_gather_finish.launches == before + 1
        want = rg.route_gather_finish_ref(x, idx, **kw)
        if dtype == "f32":
            got, want = got.view(torch.int32), want.view(torch.int32)
        assert torch.equal(got, want), (n, offset, kw.keys(),
                                        kw.get("weight_op"))


@pytest.mark.parametrize("n", [128, 1 << 12, 1 << 18])
@pytest.mark.parametrize("inverse", [False, True])
def test_route_gather_bool_through_apply_route(cuda, n, inverse):
    """bool values ride the byte entry as their bytes, on a view one byte
    past a 16-byte boundary too."""
    rng = np.random.default_rng(n)
    plan = make_route_plan(rng.permutation(n), device=cuda)
    idx = plan.inv_idx if inverse else plan.fwd_idx
    for off in (0, 1):
        xb = (torch.from_numpy(rng.random(n + off) < 0.4).to(cuda))[off:]
        before = rg.route_gather_finish.launches
        got = apply_route(plan, xb, inverse=inverse)
        torch.cuda.synchronize()
        assert rg.route_gather_finish.launches == before + 1
        assert got.dtype == torch.bool
        assert torch.equal(got, xb[idx.long()])


def test_kernel_rejects_what_it_does_not_take(cuda):
    idx = torch.arange(8, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        rg.route_gather_finish(torch.zeros(8, dtype=torch.float64,
                                           device=cuda), idx)
    with pytest.raises(TypeError):
        rg.route_gather_finish(torch.zeros(8, device=cuda), idx.long())
    with pytest.raises(ValueError):
        rg.route_gather_finish(torch.zeros(8, device=cuda), idx,
                               flags=torch.zeros(8, dtype=torch.uint8))


def test_page_rank_on_cuda_matches_cpu(cuda):
    iters = 20
    ec = generation.rmat(10, 8, seed=3, weighted=False)
    cpu = pr.vgl_page_rank(import_graph(ec, device="cpu"),
                           max_iterations=iters, use_convergence=False)[0]
    g = import_graph(ec, device=cuda)
    rg.route_gather_finish.launches = 0
    pl.pull_reduce.launches = 0
    ranks = pr.vgl_page_rank(g, max_iterations=iters, use_convergence=False)[0]
    torch.cuda.synchronize()
    assert rg.route_gather_finish.launches == 1        # the out-degrees
    assert pl.pull_reduce.launches == iters
    np.testing.assert_allclose(ranks.values.cpu().numpy(),
                               cpu.values.numpy(), rtol=1e-5, atol=1e-8)


def _i32(rng, n):
    return rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64).astype(np.int32)


# (n_out, n messages, destinations): uniform with an eighth dropped (past the
# end or negative), heavy duplicates on 5 targets, all dropped, empty
SCATTER_CASES = {
    "uniform": (1 << 16, 1 << 17, "uniform"),
    "duplicates": (1 << 10, 1 << 16, "dup"),
    "all-dropped": (1 << 10, 1 << 12, "drop"),
    "empty": (1 << 10, 0, "uniform"),
}


@pytest.mark.parametrize("op", ["min", "max", "or", "add"])
@pytest.mark.parametrize("case", list(SCATTER_CASES))
def test_scatter_combine_equals_plain_version(cuda, case, op):
    n_out, n, kind = SCATTER_CASES[case]
    rng = np.random.default_rng(2)
    if kind == "dup":
        idx = rng.integers(0, 5, n)
    elif kind == "drop":
        idx = np.where(rng.random(n) < 0.5, n_out + rng.integers(0, 9, n),
                       -1 - rng.integers(0, 9, n))
    else:
        idx = rng.integers(0, n_out, n)
        idx[rng.random(n) < 1 / 8] = n_out
        idx[rng.random(n) < 1 / 64] = -3
    idx = torch.from_numpy(idx.astype(np.int32)).to(cuda)
    out = torch.from_numpy(_i32(rng, n_out)).to(cuda)
    for msg in (torch.from_numpy(_i32(rng, n)).to(cuda), 1, -2**31):
        before = sc.scatter_combine.launches
        got = sc.scatter_combine(out, idx, msg, op)
        torch.cuda.synchronize()
        assert sc.scatter_combine.launches == before + 1
        assert torch.equal(got, sc.scatter_combine_ref(out, idx, msg, op))
    if kind == "drop" or n == 0:
        assert torch.equal(got, out)


def test_scatter_combine_rejects_what_it_does_not_take(cuda):
    out = torch.zeros(8, dtype=torch.int32, device=cuda)
    idx = torch.arange(8, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        sc.scatter_combine(out.double(), idx, 1, "min")
    with pytest.raises(TypeError):
        sc.scatter_combine(out.float(), idx, 1.0, "or")
    with pytest.raises(TypeError):          # no f32 add: atomics reorder it
        sc.scatter_combine(out.float(), idx, 1.0, "add")
    with pytest.raises(ValueError):         # messages of the target's type
        sc.scatter_combine(out.float(), idx, idx, "min")
    with pytest.raises(TypeError):
        sc.scatter_combine(out, idx.long(), 1, "min")
    with pytest.raises(ValueError):
        sc.scatter_combine(out, idx, 1, "xor")
    with pytest.raises(ValueError):
        sc.scatter_combine(out, idx, idx.cpu(), "max")
    # scatter_at on the card: min/max over int32 and f32 and add over int32
    # have a kernel
    with pytest.raises(TypeError):
        monoid.ADD.scatter_at(out.float(), idx, idx.float())
    before = sc.scatter_combine.launches
    got = monoid.ADD.scatter_at(out + 1, idx % 4, idx)
    assert sc.scatter_combine.launches == before + 1
    assert got.cpu().tolist() == [5, 7, 9, 11, 1, 1, 1, 1]
    with pytest.raises(TypeError):
        monoid.MIN.scatter_at(out.double(), idx, idx.double())
    before = sc.scatter_combine.launches
    got = monoid.MIN.scatter_at(out.float() + 5, idx, idx.float())
    assert sc.scatter_combine.launches == before + 1
    assert got.cpu().tolist() == [0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 5.0, 5.0]
    with pytest.raises(NotImplementedError):
        monoid.OR.scatter_at(out, idx, idx)


def test_bfs_on_cuda_matches_cpu(cuda):
    ec = generation.rmat(10, 8, seed=3, weighted=False)
    cg, g = import_graph(ec, device="cpu"), import_graph(ec, device=cuda)
    roots = [common.select_random_source(ec, seed=s) for s in range(3)]
    for src in roots:
        trace = []
        sc.scatter_combine.launches = 0
        rg.route_gather_finish.launches = 0
        pl.pull_reduce.launches = 0
        pe.push_expand.launches = 0
        got = bfs.vgl_bfs_device(g, src, id_cap=1 << 10, edge_cap=1 << 13,
                                 trace=trace)
        torch.cuda.synchronize()
        td = sum(t[0] == "td" for t in trace)
        bu = len(trace) - td
        assert sc.scatter_combine.launches == 0
        assert pe.push_expand.launches == td
        assert pl.pull_reduce.launches == bu
        # a bottom-up level routes the levels into GATHER order and back
        assert rg.route_gather_finish.launches == 2 * bu
        want = bfs.vgl_bfs_device(cg, src, id_cap=1 << 10, edge_cap=1 << 13)
        assert torch.equal(got.values.cpu(), want.values)
        np.testing.assert_array_equal(as_original_numpy(got, g),
                                      bfs.seq_top_down(ec, src))
    for fn in (bfs.vgl_top_down, lambda gr, s: bfs.vgl_bfs(gr, s, alpha=1e-9)):
        assert torch.equal(fn(g, roots[0]).values.cpu(),
                           fn(cg, roots[0]).values)
    assert torch.equal(bfs.vgl_msbfs(g, roots * 11).values.cpu(),
                       bfs.vgl_msbfs(cg, roots * 11).values)


@pytest.mark.parametrize("rows", [1, 8, 1 << 10])
@pytest.mark.parametrize("dtype", ["f32", "i32", "i8", "u8", "bool"])
def test_lane_shuffle_equals_plain_version(cuda, dtype, rows):
    rng = np.random.default_rng(rows)
    idx = np.argsort(rng.random((rows, 128)), axis=1).astype(np.int32)
    shape = (rows, 128)
    x = {"f32": lambda: rng.standard_normal(shape).astype(np.float32),
         "i32": lambda: _i32(rng, rows * 128).reshape(shape),
         "i8": lambda: rng.integers(-128, 128, shape).astype(np.int8),
         "u8": lambda: rng.integers(0, 256, shape).astype(np.uint8),
         "bool": lambda: rng.integers(0, 2, shape).astype(bool)}[dtype]()
    x, idx = torch.from_numpy(x).to(cuda), torch.from_numpy(idx).to(cuda)
    for ix in (idx, torch.zeros_like(idx), idx.flip(1).contiguous()):
        before = ls.lane_shuffle.launches
        got = ls.lane_shuffle(x, ix)
        torch.cuda.synchronize()
        assert ls.lane_shuffle.launches == before + 1
        want = ls.lane_shuffle_ref(x, ix)
        assert got.dtype == want.dtype
        if dtype == "f32":
            got, want = got.view(torch.int32), want.view(torch.int32)
        assert torch.equal(got, want)


def test_lane_shuffle_rejects_what_it_does_not_take(cuda):
    x = torch.zeros(4, 128, device=cuda)
    idx = torch.zeros(4, 128, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        ls.lane_shuffle(x.double(), idx)
    with pytest.raises(TypeError):
        ls.lane_shuffle(x, idx.long())
    with pytest.raises(ValueError):
        ls.lane_shuffle(torch.zeros(4, 64, device=cuda), idx[:, :64])
    with pytest.raises(ValueError):
        ls.lane_shuffle(x, idx.cpu())
    with pytest.raises(ValueError):         # 4-byte offset: not 16-aligned
        ls.lane_shuffle(torch.zeros(4 * 128 + 1, device=cuda)[1:]
                        .view(4, 128), idx)


def test_cuda_load_equals_cpu_load(cuda, tmp_path):
    ec = generation.rmat(10, 8, seed=3, weighted=False)
    path = str(tmp_path / "g.npz")
    save_graph_to_binary_file(import_graph(ec, device="cpu"), path)
    cg = load_graph_from_binary_file(path, device="cpu")
    ls.lane_shuffle.launches = 0
    g = load_graph_from_binary_file(path, device=cuda)
    torch.cuda.synchronize()
    assert ls.lane_shuffle.launches == 8
    for name in ("advance_route", "vertex_route_s_from_g",
                 "vertex_route_s_from_o", "vertex_route_g_from_o"):
        a, b = getattr(g, name), getattr(cg, name)
        for f in ("fwd_idx", "inv_idx", "flags_fwd", "flags_inv"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), (name, f)
            if x is not None:
                assert torch.equal(x.cpu(), y), (name, f)
    for d in ("outgoing", "incoming"):
        for a, b in zip(getattr(g, d).buckets, getattr(cg, d).buckets):
            assert torch.equal(a.adj.cpu(), b.adj)
    ranks = pr.vgl_page_rank(g, max_iterations=20, use_convergence=False)[0]
    want = pr.vgl_page_rank(cg, max_iterations=20, use_convergence=False)[0]
    np.testing.assert_allclose(ranks.values.cpu().numpy(),
                               want.values.numpy(), rtol=1e-5, atol=1e-8)


@pytest.fixture(scope="module")
def rmat12_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the kernel has no CPU mode)")
    ec = generation.rmat(12, 16, seed=5, weighted=False)
    return ec, import_graph(ec, device="cuda")


PULL_CASES = [("f32", "add"), ("f32", "min"), ("f32", "max"), ("i32", "add"),
              ("i32", "min"), ("i32", "max"), ("i32", "or"), ("i8", "add"),
              ("i8", "min"), ("i8", "max"), ("i8", "or"), ("i8", "any01")]


@pytest.mark.parametrize("d", ["G", "S"])
@pytest.mark.parametrize("dtype,op", PULL_CASES)
def test_pull_reduce_equals_plain_version(rmat12_cuda, d, dtype, op):
    """The graph's kept plan and a plan made for the call give the plain
    version's result, and two f32 add pulls the same bits."""
    _, g = rmat12_cuda
    dg = g.direction(bfs.G if d == "G" else bfs.S)
    n = g.v_pad
    rng = np.random.default_rng(3)
    x = {"f32": lambda: rng.random(n).astype(np.float32),
         "i32": lambda: _i32(rng, n),
         "i8": lambda: (rng.integers(0, 2, n) if op == "any01"
                        else rng.integers(-128, 128, n)).astype(np.int8)
         }[dtype]()
    x = torch.from_numpy(x).cuda()
    for excl in (False, True):
        want = pl.pull_reduce_ref(dg.row_ptr, dg.col_idx, x, op, excl)
        for plan in (advance.pull_plan(dg), None):
            before = pl.pull_reduce.launches
            got = pl.pull_reduce(dg.row_ptr, dg.col_idx, x, op, excl, plan)
            torch.cuda.synchronize()
            assert pl.pull_reduce.launches == before + 1
            assert got.dtype == want.dtype and got.shape == (n,)
            if (dtype, op) == ("f32", "add"):
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
                again = pl.pull_reduce(dg.row_ptr, dg.col_idx, x, op, excl,
                                       plan)
                assert torch.equal(got.view(torch.int32),
                                   again.view(torch.int32))
            else:
                assert torch.equal(got, want)


def test_pull_reduce_propagates_nan(cuda):
    """min/max take NaN over any number, as torch.minimum/maximum do."""
    row_ptr = torch.tensor([0, 3, 5, 5], dtype=torch.int32, device=cuda)
    col_idx = torch.tensor([0, 1, 2, 2, 3], dtype=torch.int32, device=cuda)
    x = torch.tensor([1.0, float("nan"), -2.0, 4.0], device=cuda)
    for op, rest in (("min", -2.0), ("max", 4.0)):
        for plan in (None, pl.make_plan(row_ptr)):
            got = pl.pull_reduce(row_ptr, col_idx, x, op, plan=plan).cpu()
            assert torch.isnan(got[0]) and got[1].item() == rest
            assert got[2].item() == (float("inf") if op == "min"
                                     else float("-inf"))


def _f32_specials(rng, n, nan_share=0.03) -> np.ndarray:
    x = rng.choice(np.array([-0.0, 0.0, 1.0, -1.0, 3.0], np.float32), n,
                   p=[0.35, 0.35, 0.1, 0.1, 0.1]).astype(np.float32)
    x[rng.random(n) < nan_share] = np.nan
    return x


@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("kernel", ["route", "pull", "pull-weighted",
                                    "segment", "scatter", "scatter-const",
                                    "scatter-in-place"])
def test_f32_min_max_rule_in_every_kernel(cuda, rmat12_cuda, kernel, op):
    """The three kernels that take an f32 min or max give their plain
    versions' bits on NaN, -0.0 and +0.0 (the port's one f32 rule,
    csrc/f32_minmax.cuh; the plain versions hold the JAX package's answer,
    tests/test_torch_f32_order.py)."""
    rng = np.random.default_rng(12)

    def bits_equal(got, want):
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32).cpu(),
                           want.view(torch.int32).cpu())
    if kernel == "route":
        n = 1 << 16
        idx = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(cuda)
        flags = torch.from_numpy(rng.integers(0, 4, n).astype(np.uint8)
                                 ).to(cuda)
        x, w = (torch.from_numpy(_f32_specials(rng, n)).to(cuda)
                for _ in range(2))
        args = (x, idx, flags, w, op, True, -7.0)
        bits_equal(rg.route_gather_finish(*args),
                   rg.route_gather_finish_ref(*args))
        return
    if kernel.startswith("scatter"):
        n_out, n = 1 << 12, 1 << 16
        out = torch.from_numpy(_f32_specials(rng, n_out, 0.01)).to(cuda)
        idx = torch.from_numpy(rng.integers(-3, n_out + 3, n).astype(
            np.int32)).to(cuda)
        msgs = [torch.from_numpy(_f32_specials(rng, n, 0.0005)).to(cuda)]
        if kernel == "scatter-const":
            msgs = [float("nan"), -0.0, 0.0]
        for msg in msgs:
            want = sc.scatter_combine_ref(out, idx, msg, op)
            if kernel == "scatter-in-place":
                got = sc.scatter_combine_(out.clone(), idx, msg, op)
            else:
                got = sc.scatter_combine(out, idx, msg, op)
            bits_equal(got, want)
        return
    _, g = rmat12_cuda
    dg = g.incoming
    x = torch.from_numpy(_f32_specials(rng, g.v_pad, 0.002)).to(cuda)
    if kernel == "segment":
        e = int(dg.row_ptr[-1])
        msgs = torch.from_numpy(_f32_specials(rng, e, 0.002)).to(cuda)
        bits_equal(pl.segment_reduce(dg.row_ptr, msgs, op),
                   pl.segment_reduce_ref(dg.row_ptr, msgs, op))
        return
    w = wop = None
    if kernel == "pull-weighted":
        w = torch.from_numpy(_f32_specials(rng, dg.col_idx.numel(), 0.002)
                             ).to(cuda)
        wop = "max" if op == "min" else "min"
    for plan in (None, pl.make_plan(dg.row_ptr)):
        got = pl.pull_reduce(dg.row_ptr, dg.col_idx, x, op, plan=plan,
                             weights=w, weight_op=wop)
        bits_equal(got, pl.pull_reduce_ref(dg.row_ptr, dg.col_idx, x, op,
                                           weights=w, weight_op=wop))


def test_pull_reduce_rejects_what_it_does_not_take(cuda):
    row_ptr = torch.tensor([0, 1, 2], dtype=torch.int32, device=cuda)
    col_idx = torch.tensor([1, 0], dtype=torch.int32, device=cuda)
    x = torch.zeros(2, device=cuda)
    with pytest.raises(TypeError):
        pl.pull_reduce(row_ptr, col_idx, x.double(), "add")
    with pytest.raises(TypeError):
        pl.pull_reduce(row_ptr, col_idx, x, "or")
    with pytest.raises(ValueError):
        pl.pull_reduce(row_ptr.long(), col_idx, x, "add")
    with pytest.raises(ValueError):
        pl.pull_reduce(row_ptr, col_idx.cpu(), x, "add")
    with pytest.raises(ValueError):
        pl.pull_reduce(row_ptr, col_idx, x, "mul")
    with pytest.raises(ValueError):        # a plan of another row_ptr
        pl.pull_reduce(row_ptr, col_idx, x, "add",
                       plan=pl.make_plan(row_ptr.clone()))


PUSH_CASES = ["2^10", "2^14", "overflow", "zero-degree", "empty"]


@pytest.mark.parametrize("op", ["min", "max", "or"])
@pytest.mark.parametrize("case", PUSH_CASES)
def test_push_expand_equals_plain_version(rmat12_cuda, case, op):
    _, g = rmat12_cuda
    dg = g.outgoing
    rng = np.random.default_rng(4)
    degs = dg.degrees.cpu().numpy()
    order = rng.permutation(np.flatnonzero(degs[:g.v] > 0))
    target = {"2^10": 1 << 10, "overflow": 1 << 12}.get(case, 1 << 14)
    pick = order[:max(int(np.searchsorted(np.cumsum(degs[order]), target)), 1)]
    mask = np.zeros(g.v_pad, bool)
    if case != "empty":
        mask[pick] = True
    if case == "zero-degree":
        mask[np.flatnonzero(degs[:g.v] == 0)[:64]] = True
    fr = frontier.from_mask(g, torch.from_numpy(mask).cuda(), bfs.S)
    size, nbrs = int(fr.size), int(fr.neighbours_count)
    ids, valid = frontier.compact_ids(fr, common.next_pow2(max(size, 8)) * 2)
    ecap = max(nbrs // 2 if case == "overflow" else nbrs, 64)
    out = torch.from_numpy(_i32(rng, g.v_pad)).cuda()
    msg = {"min": 5, "max": 7, "or": -2**31 | 5}[op]
    before = pe.push_expand.launches
    got = pe.push_expand(out, dg.row_ptr, dg.col_idx, dg.degrees, ids, valid,
                         ecap, msg, op)
    torch.cuda.synchronize()
    assert pe.push_expand.launches == before + 1
    want = pe.push_expand_ref(out, dg.row_ptr, dg.col_idx, dg.degrees, ids,
                              valid, ecap, msg, op)
    assert torch.equal(got, want)
    assert torch.equal(got, out) == (case == "empty")


def test_push_expand_rejects_what_it_does_not_take(cuda):
    out = torch.zeros(8, dtype=torch.int32, device=cuda)
    rp = torch.zeros(9, dtype=torch.int32, device=cuda)
    ci = torch.zeros(8, dtype=torch.int32, device=cuda)
    ids = torch.zeros(4, dtype=torch.int32, device=cuda)
    valid = torch.ones(4, dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        pe.push_expand(out.float(), rp, ci, ci, ids, valid, 8, 1, "min")
    with pytest.raises(ValueError):
        pe.push_expand(out, rp, ci, ci, ids.long(), valid, 8, 1, "min")
    with pytest.raises(ValueError):
        pe.push_expand(out, rp, ci, ci, ids.cpu(), valid, 8, 1, "min")
    with pytest.raises(ValueError):
        pe.push_expand(out, rp, ci, ci, ids, valid, 8, 1, "add")
    with pytest.raises(ValueError):
        pe.push_expand(out, rp, ci, ci, ids, valid, 8, 2**31, "min")


@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("case", list(SCATTER_CASES))
def test_scatter_combine_f32_equals_plain_version(cuda, case, op):
    """f32 min and max, bit for bit: random messages of both signs with
    +-inf, NaN, -0.0 and +0.0 entries, into a target that holds them too,
    as a tensor and as one constant (the port's one f32 rule,
    csrc/f32_minmax.cuh)."""
    n_out, n, kind = SCATTER_CASES[case]
    rng = np.random.default_rng(5)
    if kind == "dup":
        idx = rng.integers(0, 5, n)
    elif kind == "drop":
        idx = np.where(rng.random(n) < 0.5, n_out + rng.integers(0, 9, n),
                       -1 - rng.integers(0, 9, n))
    else:
        idx = rng.integers(0, n_out, n)
        idx[rng.random(n) < 1 / 8] = n_out
        idx[rng.random(n) < 1 / 64] = -3
    idx = torch.from_numpy(idx.astype(np.int32)).to(cuda)
    out = rng.standard_normal(n_out).astype(np.float32) * 100
    out[::5] = np.inf if op == "min" else -np.inf
    out[1::7], out[2::7], out[3::301] = 0.0, -0.0, np.nan
    out = torch.from_numpy(out).to(cuda)
    msgs = rng.standard_normal(n).astype(np.float32) * 100
    msgs[::97] = np.inf
    msgs[3::89] = -np.inf
    msgs[5::11], msgs[6::13], msgs[7::1009] = -0.0, 0.0, np.nan
    for msg in (torch.from_numpy(msgs).to(cuda), 1.5, -2.25, float("inf"),
                float("nan"), -0.0, 0.0):
        before = sc.scatter_combine.launches
        got = sc.scatter_combine(out, idx, msg, op)
        torch.cuda.synchronize()
        assert sc.scatter_combine.launches == before + 1
        want = sc.scatter_combine_ref(out, idx, msg, op)
        assert got.dtype == torch.float32
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if kind == "drop" or n == 0:
        assert torch.equal(got.view(torch.int32), out.view(torch.int32))


def _scatter_inputs(rng, case, dtype, op):
    n_out, n, kind = SCATTER_CASES[case]
    if kind == "dup":
        idx = rng.integers(0, 5, n)
    elif kind == "drop":
        idx = np.where(rng.random(n) < 0.5, n_out + rng.integers(0, 9, n),
                       -1 - rng.integers(0, 9, n))
    else:
        idx = rng.integers(0, n_out, n)
        idx[rng.random(n) < 1 / 8] = n_out
        idx[rng.random(n) < 1 / 64] = -3
    if dtype == "i32":
        out, msg = _i32(rng, n_out), _i32(rng, n)
    else:
        out = rng.standard_normal(n_out).astype(np.float32) * 100
        out[::5] = np.inf if op == "min" else -np.inf
        msg = rng.standard_normal(n).astype(np.float32) * 100
    return (torch.from_numpy(out).cuda(),
            torch.from_numpy(idx.astype(np.int32)).cuda(),
            torch.from_numpy(msg).cuda())


@pytest.mark.parametrize("dtype,op", [("i32", "min"), ("i32", "max"),
                                      ("i32", "or"), ("i32", "add"),
                                      ("f32", "min"), ("f32", "max")])
@pytest.mark.parametrize("case", list(SCATTER_CASES))
def test_scatter_combine_in_place_equals_copy_and_plain(cuda, case, dtype,
                                                        op):
    """scatter_combine_ combines into its target itself and returns it, bit
    for bit equal to scatter_combine (which leaves its target alone) and to
    the plain versions, copying and in place; one launch each, on the
    kernel's one count."""
    out, idx, msgs = _scatter_inputs(np.random.default_rng(9), case, dtype,
                                     op)
    const = 7 if dtype == "i32" else -2.5
    for msg in (msgs, const):
        keep = out.clone()
        before = sc.scatter_combine.launches
        want = sc.scatter_combine(out, idx, msg, op)
        target = out.clone()
        got = sc.scatter_combine_(target, idx, msg, op)
        torch.cuda.synchronize()
        assert sc.scatter_combine.launches == before + 2
        assert got is target
        assert torch.equal(out.view(torch.int32), keep.view(torch.int32))
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        plain = out.cpu()
        assert sc.scatter_combine_ref_(plain, idx.cpu(),
                                       msg.cpu() if torch.is_tensor(msg)
                                       else msg, op) is plain
        assert torch.equal(got.cpu().view(torch.int32),
                           plain.view(torch.int32))


def test_scatter_at_in_place_on_the_card(cuda):
    """Monoid.scatter_at_ on the card: the kernel cases are one in-place
    launch; the others raise as scatter_at does; a view that is not
    contiguous is refused."""
    idx = torch.arange(8, dtype=torch.int32, device=cuda)
    bits = torch.zeros(8, dtype=torch.int32, device=cuda)
    before = sc.scatter_combine.launches
    got = monoid.ADD.scatter_at_(bits, idx % 4, idx)
    assert got is bits and sc.scatter_combine.launches == before + 1
    assert bits.cpu().tolist() == [4, 6, 8, 10, 0, 0, 0, 0]
    mark = torch.full((8,), -1, dtype=torch.int32, device=cuda)
    assert monoid.MAX.scatter_at_(mark, idx // 2, idx) is mark
    assert mark.cpu().tolist() == [1, 3, 5, 7, -1, -1, -1, -1]
    with pytest.raises(TypeError):
        monoid.ADD.scatter_at_(bits.float(), idx, idx.float())
    with pytest.raises(NotImplementedError):
        monoid.OR.scatter_at_(bits, idx, idx)
    with pytest.raises(ValueError):
        sc.scatter_combine_(torch.zeros(16, dtype=torch.int32,
                                        device=cuda)[::2], idx, 1, "add")


# the general entries' argument checks, each (label, call, error): every
# error the wrappers raise, for both entries (scatter_combine and
# scatter_combine_)
def _general_rejects(cuda):
    out = torch.zeros(8, dtype=torch.int32, device=cuda)
    idx = torch.arange(8, dtype=torch.int32, device=cuda)
    f = out.float()
    return [
        ("f64 out", lambda e: e(out.double(), idx, 1, "min"), TypeError),
        ("2-D out", lambda e: e(out.view(2, 4), idx, 1, "min"), TypeError),
        ("f32 or", lambda e: e(f, idx, 1.0, "or"), TypeError),
        ("f32 add", lambda e: e(f, idx, 1.0, "add"), TypeError),
        ("int64 idx", lambda e: e(out, idx.long(), 1, "min"), TypeError),
        ("2-D idx", lambda e: e(out, idx.view(2, 4), 1, "min"), TypeError),
        ("unknown op", lambda e: e(out, idx, 1, "xor"), ValueError),
        ("idx on the CPU", lambda e: e(out, idx.cpu(), 1, "min"), ValueError),
        ("strided idx", lambda e: e(out, torch.arange(
            16, dtype=torch.int32, device=cuda)[::2], 1, "min"), ValueError),
        ("msg of another type", lambda e: e(f, idx, idx, "min"), ValueError),
        ("msg on the CPU", lambda e: e(out, idx, idx.cpu(), "max"),
         ValueError),
        ("msg of another length", lambda e: e(out, idx, idx[:5], "max"),
         ValueError),
        ("2-D msg", lambda e: e(out, idx, idx.view(2, 4), "max"),
         ValueError),
        ("0-D msg", lambda e: e(out, idx, idx[0], "max"), ValueError),
        ("strided msg", lambda e: e(out, idx, torch.arange(
            16, dtype=torch.int32, device=cuda)[::2], "max"), ValueError),
        ("msg past int32", lambda e: e(out, idx, 2**31, "max"), ValueError),
    ]


@pytest.mark.parametrize("entry", ["scatter_combine", "scatter_combine_"])
def test_scatter_combine_raises_every_error(cuda, entry):
    """After the launch path was cut down, each entry still raises every
    error it raised, and launches nothing where it raises."""
    fn = getattr(sc, entry)
    for label, call, err in _general_rejects(cuda):
        before = sc.scatter_combine.launches
        with pytest.raises(err):
            call(fn)
        assert sc.scatter_combine.launches == before, label
    with pytest.raises(ValueError):
        fn(torch.zeros(4, dtype=torch.int32, device="meta"),
           torch.arange(4, dtype=torch.int32, device="meta"), 1, "min")


def _sorted_case(rng, case):
    """(n_out, non-decreasing int32 idx) of one sorted-build case: spans
    (the SORTED_SPAN words that one block owns) with no message, one
    message, every word hit, messages on both sides of every span boundary
    with an n_out that is a whole number of spans, a bitmap of 512-word rows
    with hub rows, all messages on one word, dropped indices at both ends,
    no message."""
    span = sc.SORTED_SPAN
    if case == "empty-spans":       # 3 of 7 spans hold a few messages
        n_out = 7 * span + 17
        idx = np.concatenate([rng.integers(s * span, (s + 1) * span, 40)
                              for s in (1, 4, 6)])
        idx = idx[idx < n_out]
    elif case == "one-per-span":
        n_out = 9 * span
        idx = np.arange(9) * span + rng.integers(0, span, 9)
    elif case == "span-boundaries":  # k * span - 1 and k * span, twice
        n_out = 6 * span
        edges = np.arange(1, 6) * span
        idx = np.concatenate([[0, 0, n_out - 1], edges - 1, edges, edges - 1,
                              edges, rng.integers(0, n_out, 500)])
    elif case == "every-word":
        n_out = 3 * span + 5
        idx = np.repeat(np.arange(n_out), rng.integers(1, 4, n_out))
    elif case == "hub-bitmap":      # rows of 512 words, rows 0-3 dense
        rows, words = 600, 512
        n_out = rows * words
        u = np.concatenate([np.repeat(np.arange(4), 20_000),
                            rng.integers(4, rows, 30_000)])
        idx = u * words + rng.integers(0, words, len(u))
    elif case == "one-word":
        n_out = 5 * span
        idx = np.full(50_000, 2 * span + 77)
    elif case == "dropped-ends":
        n_out = 4 * span + 3
        idx = np.concatenate([rng.integers(-2**31, 0, 3000),
                              rng.integers(0, n_out, 20_000),
                              rng.integers(n_out, 2**31 - 1, 3000),
                              [-1, n_out]])
    else:                           # "empty-idx"
        n_out = 2 * span + 1
        idx = np.zeros(0, np.int64)
    return n_out, torch.from_numpy(np.sort(idx).astype(np.int32)).cuda()


SORTED_CASES = ["empty-spans", "one-per-span", "span-boundaries",
                "every-word", "hub-bitmap",
                "one-word", "dropped-ends", "empty-idx"]


@pytest.mark.parametrize("op", ["add", "or", "min", "max"])
@pytest.mark.parametrize("case", SORTED_CASES)
def test_scatter_combine_sorted_equals_plain_version(cuda, case, op):
    """The sorted build bit for bit against its plain version, with message
    tensors over the full int32 range and one constant for all, one launch
    each on both counts; the result is a new int32 tensor on the card."""
    rng = np.random.default_rng(31)
    n_out, idx = _sorted_case(rng, case)
    for msg in (torch.from_numpy(_i32(rng, len(idx))).cuda(), 1, -2**31):
        before = (sc.scatter_combine.launches,
                  sc.scatter_combine_sorted.launches)
        got = sc.scatter_combine_sorted(n_out, idx, msg, op)
        torch.cuda.synchronize()
        assert (sc.scatter_combine.launches,
                sc.scatter_combine_sorted.launches) == (before[0] + 1,
                                                        before[1] + 1)
        assert got.dtype == torch.int32 and got.shape == (n_out,)
        assert got.is_cuda
        assert torch.equal(got, sc.scatter_combine_sorted_ref(n_out, idx,
                                                              msg, op))


def test_scatter_combine_sorted_rejects_what_it_does_not_take(cuda):
    idx = torch.arange(8, dtype=torch.int32, device=cuda)
    calls = [
        (lambda: sc.scatter_combine_sorted(8, idx.long(), 1, "add"),
         TypeError),
        (lambda: sc.scatter_combine_sorted(8, idx.view(2, 4), 1, "add"),
         TypeError),
        (lambda: sc.scatter_combine_sorted(8, idx, 1, "xor"), ValueError),
        (lambda: sc.scatter_combine_sorted(2**31, idx, 1, "add"),
         ValueError),
        (lambda: sc.scatter_combine_sorted(-1, idx, 1, "add"), ValueError),
        (lambda: sc.scatter_combine_sorted(8, torch.arange(
            16, dtype=torch.int32, device=cuda)[::2], 1, "add"), ValueError),
        (lambda: sc.scatter_combine_sorted(8, idx, idx.float(), "add"),
         ValueError),
        (lambda: sc.scatter_combine_sorted(8, idx, idx[:4], "add"),
         ValueError),
        (lambda: sc.scatter_combine_sorted(8, idx, idx.cpu(), "add"),
         ValueError),
        (lambda: sc.scatter_combine_sorted(8, idx, 2**31, "add"),
         ValueError),
    ]
    before = sc.scatter_combine_sorted.launches
    for call, err in calls:
        with pytest.raises(err):
            call()
    assert sc.scatter_combine_sorted.launches == before


def test_scatter_new_sorted_on_the_card(cuda):
    """Monoid.scatter_new_sorted on the card: an int32 add, min or max is
    one sorted-build launch; an f32 min and an int32 any01 fill and launch
    the in-place entry; what has no kernel raises as scatter_at does."""
    idx = torch.tensor([0, 0, 1, 3, 3, 3, 9], dtype=torch.int32, device=cuda)
    vals = torch.tensor([1, 2, 3, 4, 5, 6, 7], dtype=torch.int32,
                        device=cuda)
    for mon, want in ((monoid.ADD, [3, 3, 0, 15, 0]),
                      (monoid.MIN, [1, 3, 2**31 - 1, 4, 2**31 - 1]),
                      (monoid.MAX, [2, 3, -2**31, 6, -2**31])):
        before = sc.scatter_combine_sorted.launches
        got = mon.scatter_new_sorted(5, idx, vals, torch.int32)
        assert sc.scatter_combine_sorted.launches == before + 1
        assert got.cpu().tolist() == want
    before = (sc.scatter_combine.launches, sc.scatter_combine_sorted.launches)
    got = monoid.MIN.scatter_new_sorted(5, idx, vals.float(), torch.float32)
    assert got.cpu().tolist() == [1.0, 3.0, float("inf"), 4.0, float("inf")]
    got = monoid.ANY01.scatter_new_sorted(5, idx, vals % 2, torch.int32)
    assert got.cpu().tolist() == [1, 1, 0, 1, 0]
    assert (sc.scatter_combine.launches,
            sc.scatter_combine_sorted.launches) == (before[0] + 2, before[1])
    with pytest.raises(TypeError):
        monoid.ADD.scatter_new_sorted(5, idx, vals.float(), torch.float32)
    with pytest.raises(NotImplementedError):
        monoid.OR.scatter_new_sorted(5, idx, vals, torch.int32)


@pytest.fixture(scope="module")
def weighted_cuda():
    """Weighted RMAT-12 on the card and on the CPU, with both EdgeArrays."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the kernel has no CPU mode)")
    ec = generation.rmat(12, 16, seed=5, weighted=True)
    host = []
    cg = import_graph(ec, device="cpu", _host_out=host)
    g = import_graph(ec, device="cuda")
    return (ec, cg, build_edge_array_from_host(ec.weights, cg, *host), g,
            build_edge_array_from_host(ec.weights, g, *host))


WEIGHTED_PULLS = [("f32", "min", "add"), ("f32", "max", "min"),
                  ("f32", "min", "max"), ("f32", "add", "mul"),
                  ("f32", "add", "add"), ("i32", "min", "add"),
                  ("i32", "max", "min"), ("i32", "add", "mul"),
                  ("i32", "or", "max"), ("i32", "min", "max")]


@pytest.mark.parametrize("d", ["G", "S"])
@pytest.mark.parametrize("dtype,op,wop", WEIGHTED_PULLS)
def test_pull_reduce_with_weights_equals_plain_version(weighted_cuda, d, dtype,
                                                       op, wop):
    _, _, _, g, ea = weighted_cuda
    direction = bfs.G if d == "G" else bfs.S
    dg = g.direction(direction)
    n = g.v_pad
    rng = np.random.default_rng(7)
    if dtype == "f32":
        x = rng.random(n).astype(np.float32) * 300
        x[rng.random(n) < 0.3] = np.inf
        w = ea.direction(direction).flat
    else:
        x = _i32(rng, n)
        w = torch.from_numpy(_i32(rng, dg.e_pad)).cuda()
    x = torch.from_numpy(x).cuda()
    for excl in (False, True):
        want = pl.pull_reduce_ref(dg.row_ptr, dg.col_idx, x, op, excl,
                                  weights=w, weight_op=wop)
        for plan in (advance.pull_plan(dg), None):
            before = pl.pull_reduce.launches
            got = pl.pull_reduce(dg.row_ptr, dg.col_idx, x, op, excl, plan,
                                 weights=w, weight_op=wop)
            torch.cuda.synchronize()
            assert pl.pull_reduce.launches == before + 1
            assert got.dtype == want.dtype and got.shape == (n,)
            if (dtype, op) == ("f32", "add"):
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
            else:
                assert torch.equal(got, want)


def _adversarial_csr(kind, dev):
    """(row_ptr, col_idx, columns' bound) of a CSR that puts the pull's
    schedule at its edges, for the kernel's tiles of pl.TILE items: every
    edge in one row; rows of one tile's items and one more or less; tiles
    that start on an empty row; empty rows in the middle and at the tail;
    no edges; one row of one edge; a row_ptr that starts past 0."""
    t = pl.TILE
    rng = np.random.default_rng(len(kind))
    base = 0
    degs = {"one row": [3 * t + 77],
            "tile rows": [t - 1, t, t - 2, 3 * t - 1, 1, t + 1, 0, t - 1],
            "empty at tile start": ([t - 2] + [0] * 3 + [t - 4]
                                    + [0] * (t + 5)) * 3,
            "empty rows": rng.choice([0, 0, 0, 1, 2, 7, 40, 300, 5000],
                                     size=20000),
            "no edges": [0] * 5000,
            "one edge": [1],
            "offset": rng.choice([0, 1, 3, 50, 2 * t], size=3000)}[kind]
    degs = np.asarray(degs, np.int64)
    if kind == "empty rows":
        degs[-1000:] = 0
    if kind == "offset":
        base = 1001
    rp = (base + np.concatenate([[0], np.cumsum(degs)])).astype(np.int32)
    v = max(len(degs), 2)
    ci = rng.integers(0, v, int(rp[-1])).astype(np.int32)
    for r in np.flatnonzero(degs > 2)[:64]:
        ci[rp[r] + 1] = r                       # self-loops
    return (torch.from_numpy(rp).to(dev), torch.from_numpy(ci).to(dev), v)


ADVERSARIAL = ["one row", "tile rows", "empty at tile start", "empty rows",
               "no edges", "one edge", "offset"]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kind", ADVERSARIAL)
def test_pull_reduce_on_adversarial_csrs(cuda, kind, weighted):
    """Every dtype, op and weight op over a CSR at the schedule's edges,
    with and without self-loops, against the plain version (f32 add at
    rtol 1e-5, the rest exactly); two launches bit for bit; one launches
    step per call; and, once the plan is made, no read back to the host."""
    rp, ci, v = _adversarial_csr(kind, cuda)
    # the plain version reads row_ptr from 0: it gets the rebased CSR
    rp0, ci0 = rp - rp[0], ci[int(rp[0]):]
    plan = pl.make_plan(rp)
    rng = np.random.default_rng(9)
    cases = WEIGHTED_PULLS if weighted else [(d, o, None)
                                             for d, o in PULL_CASES]
    for dtype, op, wop in cases:
        x = {"f32": lambda: rng.random(v).astype(np.float32) * 300,
             "i32": lambda: _i32(rng, v),
             "i8": lambda: (rng.integers(0, 2, v) if op == "any01"
                            else rng.integers(-128, 128, v)).astype(np.int8)
             }[dtype]()
        x = torch.from_numpy(x).to(cuda)
        w = None
        if wop is not None:
            w = torch.from_numpy(
                rng.random(ci.shape[0]).astype(np.float32) * 99 + 1
                if dtype == "f32" else _i32(rng, ci.shape[0])).to(cuda)
        w0 = None if w is None else w[int(rp[0]):]
        for excl in (False, True):
            want = pl.pull_reduce_ref(rp0, ci0, x, op, excl, weights=w0,
                                      weight_op=wop)
            before = pl.pull_reduce.launches
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = pl.pull_reduce(rp, ci, x, op, excl, plan, weights=w,
                                     weight_op=wop)
                again = pl.pull_reduce(rp, ci, x, op, excl, plan, weights=w,
                                       weight_op=wop)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            assert pl.pull_reduce.launches == before + 2
            assert got.dtype == want.dtype and got.shape == want.shape
            if (dtype, op) == ("f32", "add"):
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
            else:
                assert torch.equal(got, want), (dtype, op, wop, excl)
            bits = (lambda t: t.view(torch.int32)) if dtype == "f32" \
                else (lambda t: t)
            assert torch.equal(bits(got), bits(again))


def test_pull_reduce_with_an_x_too_large_for_l1(cuda):
    """A 4-byte x over X_IN_L1_BYTES is read through L1 only below L1_COLS:
    columns on both sides of that bound, every op and with weights, give
    the plain version's result."""
    rng = np.random.default_rng(13)
    n_x = pl.X_IN_L1_BYTES // 4 + 4099
    degs = rng.integers(0, 300, 3000)
    row_ptr = torch.from_numpy(np.concatenate([[0], np.cumsum(degs)])
                               .astype(np.int32)).to(cuda)
    e = int(row_ptr[-1])
    cols = rng.integers(0, n_x, e)
    cols[::3] = rng.integers(0, pl.L1_COLS, cols[::3].shape[0])
    col_idx = torch.from_numpy(cols.astype(np.int32)).to(cuda)
    for dtype, op, wop in (("f32", "add", None), ("f32", "min", "add"),
                           ("f32", "max", "min"), ("i32", "min", None),
                           ("i32", "or", "max")):
        x = torch.from_numpy(rng.random(n_x).astype(np.float32) * 300
                             if dtype == "f32" else _i32(rng, n_x)).to(cuda)
        w = None if wop is None else torch.from_numpy(
            rng.random(e).astype(np.float32) * 99 + 1 if dtype == "f32"
            else _i32(rng, e)).to(cuda)
        got = pl.pull_reduce(row_ptr, col_idx, x, op, weights=w,
                             weight_op=wop)
        want = pl.pull_reduce_ref(row_ptr, col_idx, x, op, weights=w,
                                  weight_op=wop)
        if op == "add":
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        else:
            assert torch.equal(got, want), (dtype, op, wop)


def test_advance_reads_nothing_back_after_its_first_pull(rmat12_cuda):
    """advance_pull_value and advance_pull keep each direction's plan: after
    the first call on a graph no call copies row_ptr (or any count) to the
    host."""
    _, g = rmat12_cuda
    x = torch.rand(g.v_pad, device="cuda")
    for d in (bfs.G, bfs.S):
        advance.advance_pull_value(g, x, "add", direction=d)
        advance.advance_pull(g, {"x": x}, lambda s, dd, w: s["x"], "max",
                             direction=d)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for d in (bfs.G, bfs.S):
            advance.advance_pull_value(g, x, "add", direction=d,
                                       exclude_self_loops=True)
            advance.advance_pull_value(g, x > 0.5, "or", direction=d)
            advance.advance_pull(g, {"x": x}, lambda s, dd, w: s["x"], "min",
                                 direction=d)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_pull_reduce_rejects_bad_weights(cuda):
    row_ptr = torch.tensor([0, 1, 2], dtype=torch.int32, device=cuda)
    col_idx = torch.tensor([1, 0], dtype=torch.int32, device=cuda)
    x = torch.zeros(2, device=cuda)
    w = torch.ones(2, device=cuda)
    with pytest.raises(ValueError):
        pl.pull_reduce(row_ptr, col_idx, x, "min", weights=w)
    with pytest.raises(ValueError):
        pl.pull_reduce(row_ptr, col_idx, x, "min", weight_op="add")
    with pytest.raises(ValueError):
        pl.pull_reduce(row_ptr, col_idx, x, "min", weights=w.int(),
                       weight_op="add")
    with pytest.raises(ValueError):
        pl.pull_reduce(row_ptr, col_idx, x, "min", weights=w[:1],
                       weight_op="add")
    with pytest.raises(ValueError):
        pl.pull_reduce(row_ptr, col_idx, x, "min", weights=w.cpu(),
                       weight_op="add")
    with pytest.raises(TypeError):
        pl.pull_reduce(row_ptr, col_idx, x.to(torch.int8), "min",
                       weights=w.to(torch.int8), weight_op="add")


def test_vertex_route_takes_bool_on_the_card(cuda):
    """CC's reach masks and SSSP's changed masks: a bool vector rides the
    vertex routes as 1-byte values, one launch each, and comes back bool."""
    ec = generation.rmat(10, 8, seed=3, weighted=False)
    cg, g = import_graph(ec, device="cpu"), import_graph(ec, device=cuda)
    x = torch.from_numpy(np.random.default_rng(1).random(g.v_pad) < 0.3)
    O = cc.O
    for a, b in ((O, bfs.G), (bfs.G, O), (O, bfs.S), (bfs.S, O),
                 (bfs.S, bfs.G), (bfs.G, bfs.S)):
        before = rg.route_gather_finish.launches
        got = common.to_direction(g, x.to(cuda), a, b)
        assert rg.route_gather_finish.launches == before + 1
        assert got.dtype == torch.bool
        assert torch.equal(got.cpu(), common.to_direction(cg, x, a, b))


def _reset(*kernels):
    for k in kernels:
        k.launches = 0


def test_sssp_and_sswp_on_cuda_match_cpu(weighted_cuda):
    ec, cg, cea, g, ea = weighted_cuda
    src = common.select_random_source(ec, seed=2)
    kernels = (pl.pull_reduce, sc.scatter_combine, rg.route_gather_finish)
    _reset(*kernels)
    got, iters = sssp.vgl_dijkstra_all_active(g, ea, src)
    torch.cuda.synchronize()
    assert pl.pull_reduce.launches == iters
    assert sc.scatter_combine.launches == rg.route_gather_finish.launches == 0
    want, citers = sssp.vgl_dijkstra_all_active(cg, cea, src)
    assert iters == citers and torch.equal(got.values.cpu(), want.values)
    # the oracle adds in fp64: equal within verify_results' epsilon
    assert verify_results(as_original_numpy(got, g),
                          sssp.seq_dijkstra(ec, src)) == 0

    for kw in (dict(), dict(id_cap=64, edge_cap=512)):
        trace = []
        _reset(*kernels)
        part, piters = sssp.vgl_dijkstra_partial_device(g, ea, src,
                                                        trace=trace, **kw)
        torch.cuda.synchronize()
        pushes = sum(t[0] == "push" for t in trace)
        # a sparse step: the owner mark and the f32 min, three vertex routes
        assert sc.scatter_combine.launches == 2 * pushes
        assert rg.route_gather_finish.launches == 3 * pushes + 1
        assert pl.pull_reduce.launches == len(trace) - pushes
        cpart, cpiters = sssp.vgl_dijkstra_partial_device(cg, cea, src, **kw)
        assert piters == cpiters == len(trace)
        assert torch.equal(part.values.cpu(), cpart.values)
        assert torch.equal(part.values, got.values)
    assert pushes and pushes < len(trace)

    pa, _ = sssp.vgl_dijkstra_partial_active(g, ea, src)
    assert np.array_equal(as_original_numpy(pa, g), as_original_numpy(got, g))
    multi = sssp.vgl_dijkstra_multi(g, ea, [src, 0], all_active=False)
    assert torch.equal(multi.values[0], got.values)

    _reset(*kernels)
    caps, witers = sswp.vgl_widest_paths(g, ea, src)
    torch.cuda.synchronize()
    assert pl.pull_reduce.launches == witers
    ccaps, cwiters = sswp.vgl_widest_paths(cg, cea, src)
    assert witers == cwiters and torch.equal(caps.values.cpu(), ccaps.values)


def test_hits_and_cc_on_cuda_match_cpu(weighted_cuda):
    ec, cg, _, g, _ = weighted_cuda
    kernels = (pl.pull_reduce, rg.route_gather_finish)
    _reset(*kernels)
    auth, hub = hits.vgl_hits(g, iterations=20)
    torch.cuda.synchronize()
    assert pl.pull_reduce.launches == 40
    assert rg.route_gather_finish.launches == 42
    cauth, chub = hits.vgl_hits(cg, iterations=20)
    # rtol 1e-5 with atol 1e-6 of the largest entry, as in
    # tests/test_torch_hits.py (it says why small entries need the atol)
    for a, b in ((auth, cauth), (hub, chub)):
        want = b.values.numpy()
        np.testing.assert_allclose(a.values.cpu().numpy(), want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())

    _reset(*kernels)
    labels, iters = cc.vgl_shiloach_vishkin(g)
    torch.cuda.synchronize()
    assert pl.pull_reduce.launches == 2 * iters
    assert rg.route_gather_finish.launches == 4 * iters
    clabels, citers = cc.vgl_shiloach_vishkin(cg)
    assert iters == citers and torch.equal(labels.values.cpu(), clabels.values)
    for fn in (cc.vgl_cc_hybrid, lambda gr: cc.vgl_cc_hybrid(gr, hub=3)):
        a, ia = fn(g)
        b, ib = fn(cg)
        assert ia == ib and torch.equal(a.values.cpu(), b.values)
    assert torch.equal(cc.vgl_bfs_based(g).values.cpu(),
                       cc.vgl_bfs_based(cg).values)


def test_cc_hybrid_links_past_its_flood_on_cuda(cuda):
    """A shuffled 3 x 2,500 grid strip, whose flood is cut at 20 levels:
    the link rounds (models/cc._link_rounds) on the card give the CPU's
    labels and rounds, one component, with 2 pulls a flood level and a
    link, and one in-place scatter_combine a link that hooked."""
    from vectorgraphlibrary_tpu_torch.io.edges_container import \
        EdgesContainer
    ids = np.arange(3 * 2500).reshape(2500, 3)
    a = np.concatenate([ids[:, :-1].ravel(), ids[:-1, :].ravel()])
    b = np.concatenate([ids[:, 1:].ravel(), ids[1:, :].ravel()])
    perm = np.random.default_rng(1).permutation(ids.size)
    a, b = perm[a], perm[b]
    ec = EdgesContainer(np.concatenate([a, b]).astype(np.int32),
                        np.concatenate([b, a]).astype(np.int32), ids.size)
    g = import_graph(ec, device=cuda, build_route=False)
    cg = import_graph(ec, device="cpu", build_route=False)
    _reset(pl.pull_reduce, sc.scatter_combine)
    labels, rounds = cc.vgl_cc_hybrid(g, max_flood=20)
    torch.cuda.synchronize()
    assert sc.scatter_combine.launches == rounds >= 2
    assert pl.pull_reduce.launches == 2 * (20 + rounds + 1)
    clabels, crounds = cc.vgl_cc_hybrid(cg, max_flood=20)
    assert rounds == crounds
    assert torch.equal(labels.values.cpu(), clabels.values)
    assert bool((labels.values[:ids.size] == 0).all())
    with pytest.raises(RuntimeError, match="no fixpoint"):
        cc.vgl_cc_hybrid(g, max_flood=20, max_iterations=1)


# (rows, words, edges, chunk): a ragged last chunk, the triangle count's
# RMAT-18 word count with many chunks, one chunk of the main path's size,
# chunks of one edge, an empty edge list
POPCOUNT_CASES = [(50, 7, 1000, 128), (300, 512, 5000, 1024),
                  (4097, 512, 40000, 32768), (9, 33, 17, 1), (10, 4, 0, 16)]


@pytest.mark.parametrize("rows,words,n,chunk", POPCOUNT_CASES)
def test_and_popcount_equals_plain_version(cuda, rows, words, n, chunk):
    rng = np.random.default_rng(rows + n)
    bits = torch.from_numpy(rng.integers(-2**31, 2**31, (rows, words),
                                         dtype=np.int64).astype(np.int32))
    bits[0] = -1
    u = torch.from_numpy(rng.integers(0, rows, n).astype(np.int32))
    v = torch.from_numpy(rng.integers(0, rows, n).astype(np.int32))
    before = ap.and_popcount.launches
    got = ap.and_popcount(bits.to(cuda), u.to(cuda), v.to(cuda), chunk)
    torch.cuda.synchronize()
    assert ap.and_popcount.launches == before + (1 if n else 0)
    assert got.dtype == torch.int32
    assert torch.equal(got.cpu(), ap.and_popcount_ref(bits, u, v, chunk))


def _sparse_bitmap(rng, rows, words, pairs, hub_pairs):
    """A bitmap with a tenth of its words non-zero and four hub rows with
    every word non-zero (row 0 all ones), and pairs sorted by u whose first
    hub_pairs take the hub rows: long runs of one u on the dense case."""
    bits = rng.integers(-2**31, 2**31, (rows, words), dtype=np.int64)
    bits[rng.random((rows, words)) < 0.9] = 0
    bits[:4] = rng.integers(1, 2**31, (4, words))
    bits[0] = -1
    u = rng.integers(0, rows, pairs)
    u[:hub_pairs] = rng.integers(0, 4, hub_pairs)
    u.sort()
    v = rng.integers(0, rows, pairs)
    return (torch.from_numpy(a.astype(np.int32)) for a in (bits, u, v))


# (rows, words, pairs, chunk): the word counts of the tests' graphs (1), of
# RMAT-14 at block_bits 256 (8), not a multiple of 4 (33: scalar row loads),
# of the RMAT-18 triangle count (512: hub rows past one window of the list)
# and past 65,536 (windows by span: 16-bit offsets); chunks of 1,000, 100
# and 7 cut runs of one u, 32,768 leaves a ragged last chunk
SPARSE_POPCOUNT_CASES = [(4097, 1, 5000, 1000), (4097, 8, 20000, 1000),
                         (4097, 33, 5000, 7), (4097, 512, 20000, 1000),
                         (4097, 512, 70000, 32768), (16, 70000, 3000, 100)]


@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("rows,words,pairs,chunk", SPARSE_POPCOUNT_CASES)
def test_and_popcount_sparse_rows_equal_plain_version(cuda, rows, words,
                                                      pairs, chunk, order):
    rng = np.random.default_rng(words + pairs)
    bits, u, v = _sparse_bitmap(rng, rows, words, pairs, pairs // 7)
    if order == "shuffled":
        perm = torch.from_numpy(rng.permutation(pairs))
        u, v = u[perm], v[perm]
    before = ap.and_popcount.launches
    got = ap.and_popcount(bits.to(cuda), u.to(cuda), v.to(cuda), chunk)
    torch.cuda.synchronize()
    assert ap.and_popcount.launches == before + 1
    assert torch.equal(got.cpu(), ap.and_popcount_ref(bits, u, v, chunk))
    assert torch.equal(got[:0], ap.and_popcount(bits.to(cuda), u[:0].to(cuda),
                                                v[:0].to(cuda), chunk))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("finish", [False, True])
def test_bool_route_view_equals_cast_path(cuda, inverse, finish):
    """A bool vector rides a route as its bytes: equal to a cast to int8
    before the route (and back to bool after it without a finish)."""
    rng = np.random.default_rng(5)
    n = 1 << 12
    flags = rng.integers(0, 4, (2, n)).astype(np.uint8)
    plan = make_route_plan(rng.permutation(n), flags_fwd=flags[0],
                           flags_inv=flags[1], device=cuda)
    x = torch.from_numpy(rng.random(n) < 0.3).to(cuda)
    fin = FinishSpec(ident=0, exclude_self_loops=True) if finish else None
    got = apply_route(plan, x, inverse=inverse, finish=fin)
    idx = plan.inv_idx if inverse else plan.fwd_idx
    if finish:
        want = rg.route_gather_finish(
            x.to(torch.int8), idx,
            flags=plan.flags_inv if inverse else plan.flags_fwd,
            exclude_self_loops=True, ident=0)
    else:
        want = rg.route_gather_finish(x.to(torch.int8), idx).to(torch.bool)
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_and_popcount_rejects_what_it_does_not_take(cuda):
    bits = torch.zeros(4, 64, dtype=torch.int32, device=cuda)
    idx = torch.zeros(3, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        ap.and_popcount(bits[:, ::2], idx, idx, 4)       # not contiguous
    with pytest.raises(ValueError):
        ap.and_popcount(bits, idx.cpu(), idx, 4)
    with pytest.raises(TypeError):
        ap.and_popcount(bits.float(), idx, idx, 4)


@pytest.fixture(scope="module")
def slice6_cuda():
    """Unweighted RMAT-12 on the card and on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the kernel has no CPU mode)")
    ec = generation.rmat(12, 16, seed=5, weighted=False)
    return ec, import_graph(ec, device="cpu"), import_graph(ec, device="cuda")


def test_scc_on_cuda_matches_cpu(slice6_cuda):
    ec, cg, g = slice6_cuda
    _reset(pl.pull_reduce, rg.route_gather_finish)
    trace = []
    labels = scc.vgl_forward_backward(g, trace=trace)
    torch.cuda.synchronize()
    trims = sum(k == "trim" for k, _ in trace)
    hops = sum(n for k, n in trace if k == "flood")
    assert pl.pull_reduce.launches == 2 * trims + hops
    assert rg.route_gather_finish.launches == 4 * trims + 2 * hops
    ctrace = []
    assert torch.equal(labels.values.cpu(),
                       scc.vgl_forward_backward(cg, trace=ctrace).values)
    assert trace == ctrace


@pytest.mark.parametrize("core", [False, True])
def test_coloring_on_cuda_matches_cpu(slice6_cuda, core):
    ec, cg, g = slice6_cuda
    kw = dict(ec=ec, core_threshold=64) if core else {}
    _reset(pl.pull_reduce, rg.route_gather_finish)
    colors, rounds = coloring.vgl_coloring(g, **kw)
    torch.cuda.synchronize()
    assert pl.pull_reduce.launches == 10 * rounds
    assert rg.route_gather_finish.launches == 20 * rounds
    ccolors, crounds = coloring.vgl_coloring(cg, **kw)
    assert rounds == crounds
    assert torch.equal(colors.values.cpu(), ccolors.values)


def test_lp_and_rw_on_cuda_match_cpu(slice6_cuda):
    ec, cg, g = slice6_cuda
    labels, iters = lp.vgl_label_propagation(g, max_iterations=10)
    clabels, citers = lp.vgl_label_propagation(cg, max_iterations=10)
    assert iters == citers and torch.equal(labels.values.cpu(), clabels.values)
    src = common.select_random_source(ec, seed=41)
    finals, paths = rw.vgl_random_walk(g, np.full(256, src), walk_length=10,
                                       seed=7, store_walk_paths=True)
    again = rw.vgl_random_walk(g, np.full(256, src), walk_length=10, seed=7)
    np.testing.assert_array_equal(finals, again)
    keys = set((ec.src_ids.astype(np.int64) * ec.vertices_count
                + ec.dst_ids).tolist())
    outdeg = np.bincount(ec.src_ids, minlength=ec.vertices_count)
    step = paths[:, :-1].astype(np.int64) * ec.vertices_count + paths[:, 1:]
    ok = np.isin(step, list(keys)) | ((paths[:, :-1] == paths[:, 1:])
                                      & (outdeg[paths[:, :-1]] == 0))
    assert ok.all()
    assert rw.seq_random_walk_reachable(ec, src, 10)[finals].all()


def test_reachability_on_cuda_matches_cpu(slice6_cuda):
    ec, cg, g = slice6_cuda
    sources = np.asarray([0, 17])
    _reset(pe.push_expand)
    got = tc.reachability(ec, g, sources)
    assert pe.push_expand.launches > 0
    np.testing.assert_array_equal(got, tc.reachability(ec, cg, sources))
    np.testing.assert_array_equal(got, tc.seq_reachability(ec, sources))
    np.testing.assert_array_equal(tc.vgl_bfs_based_reachability(g, sources),
                                  tc.seq_reachability(ec, sources))


@pytest.mark.parametrize("block_bits", [256, None])
def test_triangle_count_on_cuda_matches_cpu(slice6_cuda, block_bits):
    ec, _, _ = slice6_cuda
    kernels = (pl.pull_reduce, sc.scatter_combine, sc.scatter_combine_sorted,
               ap.and_popcount)
    _reset(*kernels)
    trace = []
    got = tc.vgl_triangle_count(ec, block_bits=block_bits, trace=trace)
    blocks = sum(t is not None for t in trace)
    assert sc.scatter_combine.launches == blocks
    assert sc.scatter_combine_sorted.launches == blocks
    assert ap.and_popcount.launches == blocks
    assert pl.pull_reduce.launches == 0
    assert got == tc.vgl_triangle_count(ec, block_bits=block_bits,
                                        device="cpu")
    assert got == tc.seq_triangle_count(ec)


# ---- slice 8: the feature-row pull, the segment-reduce entry, GraphSAGE,
# the general advance and max-flow

def _csr_with_hub(rng, n, f_hub_degree):
    """A random CSR of n rows (degrees 0 to 40) whose row 3 has
    f_hub_degree edges (past pull_rows.HUB_MIN: a block of its own)."""
    from vectorgraphlibrary_tpu_torch.ops.cuda import pull_rows as prw
    degs = rng.integers(0, 40, n)
    degs[3] = f_hub_degree
    assert f_hub_degree > prw.HUB_MIN
    row_ptr = np.concatenate([[0], np.cumsum(degs)]).astype(np.int32)
    col_idx = rng.integers(0, n, int(row_ptr[-1])).astype(np.int32)
    return torch.from_numpy(row_ptr).cuda(), torch.from_numpy(col_idx).cuda()


@pytest.mark.parametrize("ints", [True, False])
@pytest.mark.parametrize("f", [1, 3, 100, 256])
def test_pull_rows_equals_plain_version(cuda, f, ints):
    """Integer-valued features sum exactly in any order: bit for bit;
    others (non-negative) at rtol 1e-5 against the plain version in f64 (an
    f32 sum of the hub row's 20,000 values drifts by about that much in any
    order); two runs give the same bits; a hub row takes a block."""
    from vectorgraphlibrary_tpu_torch.ops.cuda import pull_rows as prw
    rng = np.random.default_rng(f)
    row_ptr, col_idx = _csr_with_hub(rng, 3000, 20_000)
    x = (rng.integers(-50, 50, (3000, f)) if ints
         else rng.random((3000, f))).astype(np.float32)
    x = torch.from_numpy(x).cuda()
    csr = prw.RowCSR(row_ptr, col_idx)
    assert csr.hubs.tolist() == [3]
    before = prw.pull_rows.launches
    got = prw.pull_rows(csr, x)
    again = prw.pull_rows(prw.RowCSR(row_ptr, col_idx), x)
    torch.cuda.synchronize()
    assert prw.pull_rows.launches == before + 2
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    if ints:
        assert torch.equal(got, prw.pull_rows_ref(row_ptr, col_idx, x))
    else:
        want = prw.pull_rows_ref(row_ptr, col_idx, x.double())
        torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-6)


def test_pull_rows_scalar_path_and_rejects(cuda):
    """An x view that is not 16-byte aligned takes the scalar loads; what
    the kernel does not take raises."""
    from vectorgraphlibrary_tpu_torch.ops.cuda import pull_rows as prw
    rng = np.random.default_rng(0)
    row_ptr, col_idx = _csr_with_hub(rng, 500, 1500)
    base = torch.from_numpy(rng.integers(-9, 9, 501 * 8).astype(
        np.float32)).cuda()
    x = base[1:1 + 500 * 8].view(500, 8)             # 4-byte aligned only
    assert x.data_ptr() % 16 != 0
    csr = prw.RowCSR(row_ptr, col_idx)
    assert torch.equal(prw.pull_rows(csr, x),
                       prw.pull_rows_ref(row_ptr, col_idx, x))
    with pytest.raises(TypeError):
        prw.pull_rows(csr, x.double())
    with pytest.raises(ValueError):
        prw.pull_rows(prw.RowCSR(row_ptr.long(), col_idx), x)


def _kahan_rows(row_ptr, col_idx, x):
    """f32 sequential compensated (Kahan) sums of x's rows over each CSR
    row, in edge order, as the kernel takes them on a row that is not a
    hub (numpy, all rows a step at a time)."""
    n, f = row_ptr.shape[0] - 1, x.shape[1]
    s = np.zeros((n, f), np.float32)
    c = np.zeros((n, f), np.float32)
    deg = np.diff(row_ptr)
    for j in range(int(deg.max(initial=0))):
        rows = np.flatnonzero(deg > j)
        y = x[col_idx[row_ptr[rows] + j]] - c[rows]
        t = s[rows] + y
        c[rows] = (t - s[rows]) - y
        s[rows] = t
    return s


@pytest.mark.parametrize("f", [1, 3, 32, 100, 256])
@pytest.mark.parametrize("offset", [0, 2])
def test_pull_rows_equals_kahan_sum_in_edge_order(cuda, f, offset):
    """Rows under HUB_MIN equal an f32 sequential Kahan sum in edge order
    bit for bit, whatever the lanes (x's start `offset` floats into its
    storage, 8 bytes, takes 2 floats a lane where F allows 4); every row,
    hubs too, is within rtol 1e-5 of the f64 sum; two runs give the same
    bits. Columns are half hot (below L2_LAST_ROWS) and half anywhere in x,
    which has more rows than that."""
    from vectorgraphlibrary_tpu_torch.ops.cuda import pull_rows as prw
    rng = np.random.default_rng(100 + f)
    n, n_x = 4000, 70_000
    assert n_x > prw.L2_LAST_ROWS
    degs = rng.integers(0, 40, n)
    degs[[5, 17, 1999]] = [prw.HUB_MIN + 1, 30_000, 3_000]
    degs[[8, 9, 2500]] = [prw.HUB_MIN, 700, 0]
    row_ptr = np.concatenate([[0], np.cumsum(degs)]).astype(np.int32)
    e = int(row_ptr[-1])
    col_idx = np.where(rng.random(e) < 0.5, rng.integers(0, 600, e),
                       rng.integers(0, n_x, e)).astype(np.int32)
    x = rng.standard_normal((n_x, f)).astype(np.float32)
    csr = prw.RowCSR(torch.from_numpy(row_ptr).cuda(),
                     torch.from_numpy(col_idx).cuda())
    base = torch.empty(n_x * f + offset, device="cuda")
    xt = base[offset:].view(n_x, f)
    xt.copy_(torch.from_numpy(x))
    if offset and f % 4 == 0:
        assert prw.lanes(f, xt.data_ptr() | 4 * f)[0] == 2
    before = prw.pull_rows.launches
    got = prw.pull_rows(csr, xt)
    again = prw.pull_rows(csr, xt)
    torch.cuda.synchronize()
    assert prw.pull_rows.launches == before + 2
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    small = degs <= prw.HUB_MIN
    kahan = _kahan_rows(row_ptr, col_idx, x)
    assert np.array_equal(got.cpu().numpy()[small].view(np.int32),
                          kahan[small].view(np.int32))
    want = prw.pull_rows_ref(csr.row_ptr, csr.col_idx, xt.double())
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("d", ["G", "S"])
def test_aggregation_backward_on_cuda(rmat12_cuda, d):
    """The gradient through the transposed CSR on the card equals the
    plain version's over the CPU graph."""
    from vectorgraphlibrary_tpu_torch.models import gnn
    from vectorgraphlibrary_tpu_torch.ops.cuda import pull_rows as prw
    ec, g = rmat12_cuda
    cg = import_graph(ec, device="cpu")
    td = bfs.G if d == "G" else bfs.S
    rng = np.random.default_rng(9)
    feats = rng.integers(0, 8, (g.v_pad, 100)).astype(np.float32)
    r = rng.integers(-3, 3, (g.v_pad, 100)).astype(np.float32)
    grads = []
    for graph, dev in ((g, "cuda"), (cg, "cpu")):
        x = torch.from_numpy(feats).to(dev).requires_grad_()
        before = prw.pull_rows.launches
        (gnn.aggregate_sum_count(graph, x, td)[0]
         * torch.from_numpy(r).to(dev)).sum().backward()
        assert prw.pull_rows.launches == before + (2 if dev == "cuda" else 0)
        grads.append(x.grad.cpu())
    assert torch.equal(grads[0], grads[1])          # integer-valued: exact


SEGMENT_CUDA_CASES = [("add", "f32"), ("min", "f32"), ("max", "f32"),
                      ("add", "i32"), ("min", "i32"), ("or", "i32"),
                      ("any01", "i8"), ("max", "i8")]


@pytest.mark.parametrize("d", ["G", "S"])
@pytest.mark.parametrize("op,dtype", SEGMENT_CUDA_CASES)
def test_segment_reduce_equals_plain_version(rmat12_cuda, d, op, dtype):
    _, g = rmat12_cuda
    dg = g.direction(bfs.G if d == "G" else bfs.S)
    rng = np.random.default_rng(5)
    n = dg.e_pad
    x = {"f32": lambda: rng.standard_normal(n).astype(np.float32),
         "i32": lambda: _i32(rng, n),
         "i8": lambda: rng.integers(0, 2, n).astype(np.int8)}[dtype]()
    x = torch.from_numpy(x).cuda()
    want = pl.segment_reduce_ref(dg.row_ptr, x, op)
    for plan in (advance.pull_plan(dg), None):
        before = pl.segment_reduce.launches
        got = pl.segment_reduce(dg.row_ptr, x, op, plan)
        torch.cuda.synchronize()
        assert pl.segment_reduce.launches == before + 1
        if (op, dtype) == ("add", "f32"):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        else:
            assert torch.equal(got, want)


def test_general_advance_on_cuda_matches_cpu(rmat12_cuda):
    ec, g = rmat12_cuda
    cg = import_graph(ec, device="cpu")
    rng = np.random.default_rng(2)
    x = rng.integers(0, 100, g.v_pad).astype(np.float32)
    act = rng.random(g.v_pad) < 0.5
    for combine in ("min", "max", "add"):
        outs = []
        for graph, dev in ((g, "cuda"), (cg, "cpu")):
            xs = torch.from_numpy(x).to(dev)
            outs.append(advance.advance_pull(
                graph, {"x": xs}, lambda s, dd, w: s["x"] * 2 + dd["x"],
                combine, dst_arrays={"x": xs},
                src_active=torch.from_numpy(act).to(dev)).cpu())
        assert torch.equal(outs[0], outs[1])       # integer-valued f32


def test_graphsage_steps_on_cuda(rmat12_cuda):
    """A full-aggregation step launches pull_rows three times; losses of
    three Adam steps follow the CPU's."""
    from vectorgraphlibrary_tpu_torch.models import gnn
    from vectorgraphlibrary_tpu_torch.ops.cuda import pull_rows as prw
    ec, g = rmat12_cuda
    cg = import_graph(ec, device="cpu")
    rng = np.random.default_rng(4)
    feats = rng.random((g.v_pad, 20)).astype(np.float32)
    labels = rng.integers(0, 4, g.v_pad)
    losses = []
    for graph, dev in ((g, "cuda"), (cg, "cpu")):
        params = gnn.init_sage(torch.Generator().manual_seed(1), 20, 32,
                               4).to(dev)
        step = gnn.make_train_step(graph, torch.optim.Adam(
            params.parameters(), lr=1e-2))
        args = (torch.from_numpy(feats).to(dev),
                torch.from_numpy(labels).to(dev),
                torch.arange(g.v_pad, device=dev) < g.v)
        run = []
        for _ in range(3):
            before = prw.pull_rows.launches
            run.append(float(step(params, *args)))
            assert prw.pull_rows.launches == before + (3 if dev == "cuda"
                                                       else 0)
        losses.append(run)
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-4)
    assert losses[0][-1] < losses[0][0]


def test_max_flow_on_cuda(cuda):
    from vectorgraphlibrary_tpu_torch.apps import mf as mf_app
    from vectorgraphlibrary_tpu_torch.models import mf
    ec2 = mf_app.prepare(generation.rmat(12, 8, seed=6, weighted=False), 6)
    src = common.select_random_source(ec2, seed=3)
    sink = mf_app.sink_for(ec2, src)
    _reset(pl.pull_reduce, pl.segment_reduce)
    trace = []
    got = mf.vgl_ford_fulkerson(ec2, None, src, sink, trace=trace)
    # one pull per BFS level, the last BFS (which finds no path) included
    assert pl.pull_reduce.launches == sum(t[0] for t in trace)
    assert trace[-1][1] == 0 and len(trace) > 1
    assert got == mf.seq_ford_fulkerson(ec2, src, sink) > 0
    assert got == mf.vgl_ford_fulkerson(ec2, None, src, sink, device="cpu")
    lv = mf.vgl_mf_bfs_levels(ec2, None, ec2.weights * 0, src)
    assert pl.segment_reduce.launches == lv.max(where=lv < 2**31 - 1,
                                                initial=1)
    np.testing.assert_array_equal(
        lv, mf.vgl_mf_bfs_levels(ec2, None, ec2.weights * 0, src,
                                 device="cpu"))


def test_device_timer_against_event_pair(cuda):
    """DeviceTimer on the card times the work on the current stream as a
    manual CUDA event pair around the same work does."""
    from vectorgraphlibrary_tpu_torch.runtime.timer import DeviceTimer, block
    x = torch.rand(1 << 24, device=cuda)
    x.sum()
    torch.cuda.synchronize()
    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    got, want = [], []
    for _ in range(5):
        t = DeviceTimer(cuda).start()
        y = torch.cumsum(x, 0)
        got.append(t.stop(y))
        begin.record()
        y = torch.cumsum(x, 0)
        end.record()
        end.synchronize()
        want.append(begin.elapsed_time(end) / 1e3)
    assert block({"y": [y, (x,)]})["y"][0] is y
    g, w = min(got), min(want)
    assert g > 0 and abs(g - w) <= 0.25 * w + 2e-5, (got, want)


def test_prim_profile_on_cuda(cuda):
    """profile_graph_primitives on a scale-14 graph: the five rows, every
    one at or under the card's 3,350 GB/s, and reps + 1 launches of the
    route, pull and scatter kernels per row that runs them."""
    from vectorgraphlibrary_tpu_torch.config import VGLConfig
    from vectorgraphlibrary_tpu_torch.runtime import prim_profile, runtime
    from vectorgraphlibrary_tpu_torch.runtime.perf_stats import (
        H100_HBM_GBPS, PerformanceStats)
    _, graph, weights = runtime.prepare_graph(
        VGLConfig(scale=14, avg_degree=16, seed=42), need_weights=True,
        device=cuda)
    reps = 3
    for w, min_row in ((weights, "advance (pull min+w)"),
                       (None, "advance (pull min)")):
        stats = PerformanceStats()
        before = (rg.route_gather_finish.launches, pl.pull_reduce.launches,
                  sc.scatter_combine.launches)
        prim_profile.profile_graph_primitives(graph, w, stats=stats,
                                              reps=reps)
        after = (rg.route_gather_finish.launches, pl.pull_reduce.launches,
                 sc.scatter_combine.launches)
        assert [a - b for a, b in zip(after, before)] == \
            [reps + 1, 2 * (reps + 1), 2 * (reps + 1)]
        assert set(stats.stats) == {
            "reorder (vertex route)", "advance (pull add)", min_row,
            "advance (push sparse)", "generate_new_frontier"}
        for name, st in stats.stats.items():
            gbps = st.bytes_requested / st.wall_s / 1e9
            assert st.calls == 1 and 0 < gbps <= H100_HBM_GBPS, (name, gbps)


def test_device_memory_profile_on_cuda(cuda, tmp_path):
    import pickle
    from vectorgraphlibrary_tpu_torch.runtime import profiling
    keep = torch.ones(1 << 20, device=cuda)
    path = tmp_path / "mem.pickle"
    profiling.device_memory_profile(str(path))
    segments = pickle.loads(path.read_bytes())
    assert path.stat().st_size > 0 and keep.is_cuda
    assert segments and all(s["device"] == torch.cuda.current_device()
                            for s in segments)


# ---------------------------------------------------------------------------
# distribution, part 1: the sharded container and its runners on the card
# ---------------------------------------------------------------------------

SHARD_CASES = ["pr", "bfs", "sssp", "cc", "hits"]


@pytest.fixture(scope="module")
def sharded12():
    """RMAT-12 (degree 8, seed 5, weighted) in 4 shards on the CPU and on
    the card, with each shard's weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the kernel has no CPU mode)")
    from vectorgraphlibrary_tpu_torch.parallel import shard_build
    ec = generation.rmat(12, 8, seed=5, weighted=True)
    out = {}
    for dev in ("cpu", "cuda"):
        hosts = []
        sg = shard_build.import_sharded(ec, 4, device=dev, _host_out=hosts)
        out[dev] = (sg, shard_build.shard_edge_values(ec.weights, sg, ec,
                                                      hosts))
    return ec, out


def _sharded_run(case, ec, sg, weights):
    from vectorgraphlibrary_tpu_torch.parallel import sharded
    if case == "pr":
        return (sharded.pagerank_sharded_scan(sg, ec, 20),)
    if case == "bfs":
        return (sharded.bfs_sharded_scan(sg, common.select_random_source(
            ec, seed=1)),)
    if case == "sssp":
        return sharded.sssp_sharded_scan(sg, weights,
                                         common.select_random_source(ec))[:1]
    if case == "cc":
        return sharded.cc_sharded_scan(sg)[:1]
    return sharded.hits_sharded_scan(sg, 10)


@pytest.mark.parametrize("case", SHARD_CASES)
def test_sharded_scan_on_cuda_matches_cpu(sharded12, case):
    """The one-card runners on the card equal their CPU run (PageRank and
    HITS within rtol 1e-5: the pull's f32 sums run in another order), with
    only pull_reduce and route_gather_finish launched, 2 routes per pull
    (3 with SSSP's source mask)."""
    ec, by_dev = sharded12
    pl.pull_reduce.launches = rg.route_gather_finish.launches = 0
    got = _sharded_run(case, ec, *by_dev["cuda"])
    torch.cuda.synchronize()
    pulls, routes = pl.pull_reduce.launches, rg.route_gather_finish.launches
    assert pulls > 0 and pulls % 4 == 0
    assert routes == (3 if case == "sssp" else 2) * pulls
    want = _sharded_run(case, ec, *by_dev["cpu"])
    for g, w in zip(got, want):
        if case in ("pr", "hits"):
            np.testing.assert_allclose(
                g.cpu().numpy(), w.numpy(), rtol=1e-5,
                atol=1e-6 * float(w.abs().max()) if case == "hits" else 0)
        else:
            assert torch.equal(g.cpu(), w)


def test_sharded_load_on_cuda(sharded12, tmp_path):
    """A sharded graph saved from the CPU loads on the card with 8
    lane_shuffle launches per shard, and its PageRank is bit-equal to the
    card's fresh sharded graph's."""
    from vectorgraphlibrary_tpu_torch.graph.persistence import (
        load_sharded_graph, save_sharded_graph)
    from vectorgraphlibrary_tpu_torch.parallel import sharded
    ec, by_dev = sharded12
    prefix = str(tmp_path / "g")
    save_sharded_graph(by_dev["cpu"][0], prefix)
    ls.lane_shuffle.launches = 0
    loaded = load_sharded_graph(prefix, device="cuda")
    assert ls.lane_shuffle.launches == 8 * 4
    assert torch.equal(sharded.pagerank_sharded_scan(loaded, ec, 20),
                       sharded.pagerank_sharded_scan(by_dev["cuda"][0], ec,
                                                     20))


def test_rank_runners_on_the_card(sharded12):
    """The dry run's rank function on one NCCL rank and on 2 gloo ranks
    that share the card: the rank-parallel runners equal the card's scan
    runners, with part 2's drivers and GraphSAGE step. Needs no second
    card."""
    from vectorgraphlibrary_tpu_torch.parallel.launch import run_ranks
    ec, by_dev = sharded12
    kw = dict(scale=12, degree=8, seed=5, source=0, pr_iterations=20,
              hits_iterations=10, coo_steps=2)
    runs = (run_ranks("vectorgraphlibrary_tpu_torch.parallel.dryrun:"
                      "sharded_rank", 1, device="cuda", kwargs=kw,
                      timeout=300)
            + run_ranks("vectorgraphlibrary_tpu_torch.parallel.dryrun:"
                        "sharded_rank", 2, device="cuda", backend="gloo",
                        kwargs=kw, timeout=300))
    from vectorgraphlibrary_tpu_torch.parallel import sharded
    sg = by_dev["cuda"][0]
    want_pr = sharded.pagerank_sharded_scan(sg, ec, 20).cpu().numpy()
    want_bfs = sharded.bfs_sharded_scan(sg, 0).cpu().numpy()
    want_msbfs = sharded.msbfs_sharded_scan(sg, torch.arange(32)).cpu()
    for r in runs:
        np.testing.assert_allclose(r["pr"], want_pr, rtol=1e-5)
        np.testing.assert_array_equal(r["bfs"], want_bfs)
        # distribution part 2 on the card: DO-BFS and partial SSSP equal
        # the pull BFS and all-active SSSP, MS-BFS the card's scan
        np.testing.assert_array_equal(r["bfs_do"], want_bfs)
        np.testing.assert_array_equal(r["sssp_partial"], r["sssp"])
        np.testing.assert_array_equal(r["msbfs"], want_msbfs.numpy())
        assert np.isfinite(r["sage_loss"])


def test_scaling_app_on_the_card(cuda, capsys):
    """apps/scaling.py without --cpu: gloo ranks on CUDA tensors sharing
    the card; its JSON line names the card."""
    import json
    from vectorgraphlibrary_tpu_torch.apps import scaling
    assert scaling.main(["--devices", "1,2", "-s", "12", "--iters", "3"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["device"] == torch.cuda.get_device_name(0)
    assert [r["devices"] for r in res["results"]] == [1, 2]
    assert all(r["mteps"] > 0 for r in res["results"])


@pytest.fixture(scope="module")
def slim12():
    """sharded12's graph as slim shards on the CPU and on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the kernel has no CPU mode)")
    from vectorgraphlibrary_tpu_torch.parallel import shard_build
    ec = generation.rmat(12, 8, seed=5, weighted=True)
    return ec, {dev: shard_build.import_sharded(ec, 4, device=dev, slim=True)
                for dev in ("cpu", "cuda")}


# the pulls of distribution part 2: (what, combine, x's kind, directions)
PART2_PULLS = [("msbfs words", "or", "words", "G"),
               ("coloring banned words", "or", "words", "GS"),
               ("coloring priorities", "min", "i32", "GS"),
               ("coloring neighbour colors", "max", "i32", "GS"),
               ("cc flood", "or", "bool", "GS"),
               ("cc hook", "min", "i32", "GS"),
               ("sssp hashed weights", "min", "f32", "G")]


@pytest.mark.parametrize("what,combine,kind,dirs", PART2_PULLS)
def test_part2_pulls_on_the_card(slim12, what, combine, kind, dirs):
    """Each type and op pair that the part 2 paths pull (int32 or of
    words, int32 min and max, bool or, which runs as int8 any01, f32 min of
    value + weight) on slim shards: the kernel equals the plain version,
    one pull_reduce launch per shard."""
    from vectorgraphlibrary_tpu_torch.parallel import sharded
    ec, by_dev = slim12
    n = by_dev["cpu"].v_pad
    rng = np.random.default_rng(7)
    x = {"words": lambda: rng.integers(-2**31, 2**31, n, dtype=np.int64)
         .astype(np.int32),
         "i32": lambda: _i32(rng, n),
         "bool": lambda: rng.random(n) < 0.1,
         "f32": lambda: np.where(rng.random(n) < 0.3, rng.random(n),
                                 np.inf).astype(np.float32)}[kind]()
    for d in dirs:
        out = {}
        for dev, sg in by_dev.items():
            kw = {}
            if kind == "f32":
                kw = dict(weight_op="add", weight_fn=sharded.
                          slot_hash_weight_fn(sharded.route_slot_count(
                              sg.shard(0))))
            pl.pull_reduce.launches = 0
            out[dev] = sharded.sharded_pull_scan(
                sg, torch.from_numpy(x).to(dev), combine,
                direction=bfs.G if d == "G" else bfs.S, **kw)
            if dev == "cuda":
                torch.cuda.synchronize()
                assert pl.pull_reduce.launches == 4, what
        assert torch.equal(out["cuda"].cpu(), out["cpu"]), (what, d)


PART2_SCANS = ["msbfs", "cc_hybrid", "coloring", "sssp_hash"]


@pytest.mark.parametrize("case", PART2_SCANS)
def test_part2_scans_on_cuda_match_cpu(slim12, case):
    """The one-card twins of part 2 on slim shards on the card equal
    their CPU run exactly."""
    from vectorgraphlibrary_tpu_torch.parallel import sharded
    ec, by_dev = slim12
    run = {"msbfs": lambda sg: (sharded.msbfs_sharded_scan(
               sg, torch.arange(32) * 7),),
           "cc_hybrid": lambda sg: sharded.cc_hybrid_sharded_scan(sg, 0),
           "coloring": lambda sg: (sharded.coloring_sharded_scan(sg,
                                                                 words=1),),
           "sssp_hash": lambda sg: sharded.sssp_sharded_scan_hash(sg, 0)
           }[case]
    got, want = run(by_dev["cuda"]), run(by_dev["cpu"])
    for g, w in zip(got, want):
        if isinstance(g, torch.Tensor):
            assert torch.equal(g.cpu(), w)
        else:
            assert g == w


@pytest.mark.parametrize("world,backend", [(1, None), (2, "gloo")])
def test_sharded_aggregate_on_the_card(cuda, world, backend, monkeypatch):
    """The sharded GraphSAGE aggregation's forward and backward
    (pull_rows over each shard's ORIGINAL-order CSR and its transpose,
    merged by all_reduce) on one NCCL rank and on 2 gloo ranks that share
    the card, against the plain pull_rows in f64: rtol 1e-5. The rank
    function's module is named from tests/ itself: an installed package
    called `tests` would shadow this directory as a package."""
    import os
    from vectorgraphlibrary_tpu_torch.parallel.launch import run_ranks
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__))]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
           if p]))
    for r in run_ranks("torch_rank_cases:sage_agg_rank", world,
                       device="cuda", backend=backend, timeout=300):
        np.testing.assert_allclose(r["out"], r["want_out"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(r["grad"], r["want_grad"], rtol=1e-5,
                                   atol=1e-6)


def test_streaming_on_the_card(sharded12, tmp_path):
    """Streamed from pinned host shards to the card: PageRank within rtol
    1e-5, MS-BFS, CC hybrid and SSSP on stored weights exactly as the
    card's resident scans, one shard resident at a time."""
    from vectorgraphlibrary_tpu_torch.graph.persistence import (
        load_sharded_weights, save_sharded_graph, save_sharded_weights)
    from vectorgraphlibrary_tpu_torch.parallel import sharded, streaming
    ec, by_dev = sharded12
    sg, weights = by_dev["cuda"]
    prefix = str(tmp_path / "g")
    save_sharded_graph(by_dev["cpu"][0], prefix)
    save_sharded_weights(sharded.route_slot_weights(*by_dev["cpu"]), prefix)
    ssg = streaming.load_streamed(prefix, weights=True, device="cuda")
    assert all(t.is_pinned() for t in ssg.weights)
    rev, dmask = sharded.pr_consts(ec)
    np.testing.assert_allclose(
        streaming.pagerank_streamed(ssg, rev, dmask, 20).cpu().numpy(),
        sharded.pagerank_sharded_scan(sg, ec, 20).cpu().numpy(), rtol=1e-5)
    roots = torch.arange(32) * 7
    assert torch.equal(streaming.msbfs_streamed(ssg, roots)[0],
                       sharded.msbfs_sharded_scan(sg, roots))
    assert torch.equal(streaming.cc_hybrid_streamed(ssg, 0)[0],
                       sharded.cc_hybrid_sharded_scan(sg, 0)[0])
    stored = sharded.slot_weights_stacked(load_sharded_weights(
        prefix, 4, "cuda"), sg)
    assert torch.equal(streaming.sssp_streamed(ssg, 0)[0],
                       sharded.sssp_sharded_scan(sg, stored, 0,
                                                 partial=False)[0])
    assert ssg.peak_resident == 1 and ssg.resident == 0


def test_hash_tier_artifact_resident_and_streamed_on_the_card(cuda,
                                                              tmp_path):
    """Phase 18's path small: apps/build_scale25.py (rmat_fast, in a process
    of its own: this one has a CUDA context) at RMAT-12/16 in 8 hash shards,
    loaded resident and streamed on the card; PageRank bit for bit or within
    rtol 1e-5, stored-weight SSSP, MS-BFS and CC hybrid exactly equal."""
    import os
    import subprocess
    import sys
    from vectorgraphlibrary_tpu_torch.graph.persistence import (
        load_sharded_graph, load_sharded_weights)
    from vectorgraphlibrary_tpu_torch.parallel import sharded, streaming
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-m", "vectorgraphlibrary_tpu_torch.apps.build_scale25"],
        cwd=repo, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES="", VGL_S25_SCALE="12",
                 VGL_S25_DEGREE="16", VGL_S25_SHARDS="8", VGL_S25_WORKERS="4",
                 VGL_S25_CACHE=str(tmp_path), VGL_S25_GEN="rmat_fast"))
    assert r.returncode == 0, r.stdout + r.stderr
    prefix = str(tmp_path / "rmat12_16_slimw")
    sg = load_sharded_graph(prefix, "cuda")
    weights = sharded.slot_weights_stacked(load_sharded_weights(
        prefix, 8, "cuda"), sg)
    ssg = streaming.load_streamed(prefix, weights=True, device="cuda")
    with np.load(f"{prefix}.prconsts.npz") as z:
        rev, dmask = z["rev"], z["dmask"]
    hub = int(np.argmax(rev == rev[rev > 0].min()))
    a = sharded.pagerank_sharded_scan_consts(sg, rev, dmask, 20)
    b = streaming.pagerank_streamed(ssg, rev, dmask, 20)
    assert torch.equal(a, b) or np.allclose(a.cpu().numpy(), b.cpu().numpy(),
                                            rtol=1e-5, atol=0)
    assert torch.equal(sharded.sssp_sharded_scan(sg, weights, hub,
                                                 partial=False)[0],
                       streaming.sssp_streamed(ssg, hub)[0])
    roots = list(range(0, 320, 10))
    assert torch.equal(sharded.msbfs_sharded_scan(sg, roots),
                       streaming.msbfs_streamed(ssg, roots)[0])
    assert torch.equal(sharded.cc_hybrid_sharded_scan(sg, hub)[0],
                       streaming.cc_hybrid_streamed(ssg, hub)[0])


def test_scale24_tier_on_the_card(cuda, tmp_path):
    """The scale-24 tier small: apps/build_scale24.py (a process of its own,
    no CUDA there) at RMAT-12/8, then apps/bench_scale24.py's rows on the
    card, one row at a time: only pull_reduce and route_gather_finish
    launch, S pulls and 2S routes per whole-graph pull (3S with partial
    SSSP's source mask), and every output equal to the same rows on the
    CPU (PageRank and HITS bit for bit or within rtol 1e-5)."""
    import os
    import subprocess
    import sys
    from vectorgraphlibrary_tpu_torch.apps import bench_scale24
    from vectorgraphlibrary_tpu_torch.ops.cuda import pull_rows as prw
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-m", "vectorgraphlibrary_tpu_torch.apps.build_scale24"],
        cwd=repo, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES="", VGL_S24_SCALE="12",
                 VGL_S24_DEGREE="8", VGL_S24_CACHE=str(tmp_path)))
    assert r.returncode == 0, r.stdout + r.stderr
    prefix = str(tmp_path / "rmat12_8_slim")
    kernels = [rg.route_gather_finish, pl.pull_reduce, pl.segment_reduce,
               sc.scatter_combine, pe.push_expand, ls.lane_shuffle,
               ap.and_popcount, prw.pull_rows]
    want = {}
    bench_scale24.run(prefix, "cpu", results=want)
    sg, consts, _ = bench_scale24.load(prefix, "cuda")
    got = {}
    for name in bench_scale24.ROWS:
        for k in kernels:
            k.launches = 0
        row = bench_scale24.measure(sg, consts, "cuda", (name,), got)[0]
        torch.cuda.synchronize()
        pulls = sg.n_shards * (row["warmup_pull_steps"]
                               + bench_scale24.REPS * row["pull_steps"])
        routes = (3 if name == "sssp" else 2) * pulls
        assert [k.launches for k in kernels] == [routes, pulls] + [0] * 6, name
    for name in bench_scale24.ROWS:
        a, b = got[name], want[name]
        a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
        for x, y in zip(a, b):
            if not isinstance(x, torch.Tensor):
                assert x == y, name
            elif name in ("pagerank", "hits"):
                assert torch.equal(x.cpu(), y) or np.allclose(
                    x.cpu().numpy(), y.numpy(), rtol=1e-5,
                    atol=1e-6 * float(y.abs().max())), name
            else:
                assert torch.equal(x.cpu(), y), name


def test_lj_bench_on_the_card(cuda, monkeypatch):
    """apps/bench_lj.py's rows on the card at a reduced replica (3,001
    vertices, 42,600 edges), one row at a time: pull_reduce and
    route_gather_finish in every row, scatter_combine in SSSP's sparse
    push (small push capacities, so that both branches run); every output
    equal to the same rows on the CPU, and the check against the host
    oracle ok."""
    from vectorgraphlibrary_tpu_torch.apps import (bench_lj, exp_lj_oracle,
                                                   make_lj_replica)
    ec = make_lj_replica.replica(3001, 42600, 200)
    multi = sssp.vgl_dijkstra_multi
    monkeypatch.setattr(sssp, "vgl_dijkstra_multi", lambda g, w, s: multi(
        g, w, s, id_cap=64, edge_cap=1024, all_active=False))
    want = {}
    bench_lj.run(ec, "cpu", results=want)
    wec, g, ea, _ = bench_lj.load(ec, "cuda")
    got = {}
    for name in bench_lj.ROWS:
        for k in (rg.route_gather_finish, pl.pull_reduce, sc.scatter_combine):
            k.launches = 0
        bench_lj.measure(wec, g, ea, "cuda", (name,), got)
        torch.cuda.synchronize()
        assert rg.route_gather_finish.launches and pl.pull_reduce.launches
        assert bool(sc.scatter_combine.launches) == (name == "sssp")
        assert torch.equal(got[name].cpu(), want[name]), name
    deg = bench_lj.out_degrees(wec)
    oracle = exp_lj_oracle.oracle(wec, bench_lj.sources(deg)[1],
                                  bench_lj.roots(deg)[1])
    assert bench_lj.check(wec, g, got, oracle)["ok"]


def test_device_import_equals_host_build_on_the_card(cuda):
    """graph/device.import_graph builds both directions on the card
    (graph/build_torch): at RMAT-18/16 (4,194,304 edges) every tensor of
    the graph, the edge values and each direction's edge_perm equal the
    numpy host build uploaded by from_host, compared on the host; each
    import keeps exactly two vgl.import.csr.device spans, each inside its
    vgl.import.csr span."""
    import dataclasses
    from vectorgraphlibrary_tpu_torch.graph.build import build_directed_csr
    from vectorgraphlibrary_tpu_torch.graph.device import from_host
    from vectorgraphlibrary_tpu_torch.runtime import profiling

    def fields(obj, prefix=""):
        if isinstance(obj, torch.Tensor):
            return {prefix: obj}
        if dataclasses.is_dataclass(obj):
            return {k: x for f in dataclasses.fields(obj) for k, x in
                    fields(getattr(obj, f.name), f"{prefix}.{f.name}").items()}
        if isinstance(obj, (tuple, list)):
            return {k: x for i, y in enumerate(obj)
                    for k, x in fields(y, f"{prefix}[{i}]").items()}
        return {prefix: obj}

    ec = generation.rmat(scale=18, avg_degree=16, seed=5)
    hosts = [build_directed_csr(ec.src_ids, ec.dst_ids, ec.vertices_count),
             build_directed_csr(ec.dst_ids, ec.src_ids, ec.vertices_count)]
    want = from_host(hosts[0], hosts[1], ec.src_ids == ec.dst_ids,
                     ec.vertices_count, ec.edges_count, device=cuda,
                     build_route=False)
    records = []
    got = import_graph(ec, device=cuda, _host_out=records, build_route=False)
    kept = profiling.kept_spans()
    (_, lo, hi), = [k for k in kept if k[0] == "vgl.import"][-1:]
    csr = [k for k in kept if k[0] == "vgl.import.csr" and lo <= k[1] <= hi]
    dev = [k for k in kept
           if k[0] == "vgl.import.csr.device" and lo <= k[1] <= hi]
    assert len(csr) == len(dev) == 2
    assert all(c[1] <= d[1] <= d[2] <= c[2] for c, d in zip(csr, dev))
    assert got.device.type == "cuda"
    a, b = fields(want), fields(got)
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert b[k].device.type == "cuda", k
            assert a[k].dtype == b[k].dtype, k
            assert np.array_equal(a[k].cpu().numpy(), b[k].cpu().numpy()), k
        else:
            assert a[k] == b[k], k
    for h, r in zip(hosts, records):
        assert r.edge_perm.device.type == "cuda"
        np.testing.assert_array_equal(r.edge_perm[:h.edges_count].cpu()
                                      .numpy(), h.edge_perm[:h.edges_count])
    w_host = build_edge_array_from_host(ec.weights, want, hosts[0], hosts[1])
    w_dev = build_edge_array_from_host(ec.weights, got, records[0],
                                       records[1])
    for d in ("outgoing", "incoming"):
        assert np.array_equal(getattr(w_host, d).flat.cpu().numpy(),
                              getattr(w_dev, d).flat.cpu().numpy()), d
