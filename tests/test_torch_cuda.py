"""PyTorch port on the card: the route-gather, CSR pull (with edge weights),
scatter-combine (int32 and f32), expand-and-scatter and lane-shuffle kernels
against their plain versions (bit for bit, but f32 sums of the pull at rtol
1e-5 / atol 1e-6: another order), their launch counts, their argument
checks, and the slices (PageRank, BFS, loading a saved graph, SSSP, SSWP,
HITS, CC) on CUDA against the same slices on the CPU. Every test
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
from vectorgraphlibrary_tpu_torch.graph import frontier
from vectorgraphlibrary_tpu_torch.ops import advance, monoid
from vectorgraphlibrary_tpu_torch.ops.cuda import lane_shuffle as ls
from vectorgraphlibrary_tpu_torch.ops.cuda import pull_reduce as pl
from vectorgraphlibrary_tpu_torch.ops.cuda import push_expand as pe
from vectorgraphlibrary_tpu_torch.ops.cuda import route_gather as rg
from vectorgraphlibrary_tpu_torch.ops.cuda import scatter_combine as sc
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


@pytest.mark.parametrize("op", ["min", "max", "or"])
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
    with pytest.raises(ValueError):         # messages of the target's type
        sc.scatter_combine(out.float(), idx, idx, "min")
    with pytest.raises(TypeError):
        sc.scatter_combine(out, idx.long(), 1, "min")
    with pytest.raises(ValueError):
        sc.scatter_combine(out, idx, 1, "add")
    with pytest.raises(ValueError):
        sc.scatter_combine(out, idx, idx.cpu(), "max")
    # scatter_at on the card: min/max over int32 and f32 have a kernel
    with pytest.raises(TypeError):
        monoid.ADD.scatter_at(out, idx, idx)
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
    """Every work-unit split (the graph's classes, a warp per row, a thread
    per row, blocks then 4 threads) gives the plain version's result."""
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
    splits = (advance.row_groups(dg), None, ((n, 1),),
              ((16, pl.BLOCK), (n, 4)))
    for excl in (False, True):
        want = pl.pull_reduce_ref(dg.row_ptr, dg.col_idx, x, op, excl)
        for groups in splits:
            before = pl.pull_reduce.launches
            got = pl.pull_reduce(dg.row_ptr, dg.col_idx, x, op, excl, groups)
            torch.cuda.synchronize()
            assert pl.pull_reduce.launches == before + 1
            assert got.dtype == want.dtype and got.shape == (n,)
            if (dtype, op) == ("f32", "add"):
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
                again = pl.pull_reduce(dg.row_ptr, dg.col_idx, x, op, excl,
                                       groups)
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
        for groups in (None, ((3, 1),), ((3, pl.BLOCK),)):
            got = pl.pull_reduce(row_ptr, col_idx, x, op, groups=groups).cpu()
            assert torch.isnan(got[0]) and got[1].item() == rest
            assert got[2].item() == (float("inf") if op == "min"
                                     else float("-inf"))


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
    for groups in (((1, 32),), ((2, 64),), ((2, 32), (1, 1))):
        with pytest.raises(ValueError):
            pl.pull_reduce(row_ptr, col_idx, x, "add", groups=groups)


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
    +-inf entries (no NaN, no -0.0: the kernel orders those by bit pattern)
    as a tensor and as one constant."""
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
    out = torch.from_numpy(out).to(cuda)
    msgs = rng.standard_normal(n).astype(np.float32) * 100
    msgs[::97] = np.inf
    msgs[3::89] = -np.inf
    for msg in (torch.from_numpy(msgs).to(cuda), 1.5, -2.25, float("inf")):
        before = sc.scatter_combine.launches
        got = sc.scatter_combine(out, idx, msg, op)
        torch.cuda.synchronize()
        assert sc.scatter_combine.launches == before + 1
        want = sc.scatter_combine_ref(out, idx, msg, op)
        assert got.dtype == torch.float32
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if kind == "drop" or n == 0:
        assert torch.equal(got, out)


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
                  ("i32", "or", "max")]


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
    splits = (advance.row_groups(dg), None, ((n, 1),),
              ((16, pl.BLOCK), (n, 4)))
    for excl in (False, True):
        want = pl.pull_reduce_ref(dg.row_ptr, dg.col_idx, x, op, excl,
                                  weights=w, weight_op=wop)
        for groups in splits:
            before = pl.pull_reduce.launches
            got = pl.pull_reduce(dg.row_ptr, dg.col_idx, x, op, excl, groups,
                                 weights=w, weight_op=wop)
            torch.cuda.synchronize()
            assert pl.pull_reduce.launches == before + 1
            assert got.dtype == want.dtype and got.shape == (n,)
            if (dtype, op) == ("f32", "add"):
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
            else:
                assert torch.equal(got, want)


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
    for a, b in ((auth, cauth), (hub, chub)):
        np.testing.assert_allclose(a.values.cpu().numpy(), b.values.numpy(),
                                   rtol=1e-4, atol=1e-7)

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
