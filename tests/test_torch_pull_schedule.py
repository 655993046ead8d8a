"""PyTorch port, the CSR pull's schedule (ops/cuda/pull_reduce.make_plan)
and a numpy model of how csrc/pull_reduce.cu runs it, on the CPU.

The plan cuts the CSR's n row ends and e slots, as one merge-path sequence
of n + e items, into tiles of TILE items. The tests hold it to that
definition on the port's graphs (RMAT, self-loops, hub rows, a reduced
LiveJournal replica's Chung-Lu skew, both directions) and on CSRs that
put it at its edges (every edge in one row, rows of one tile's items and
one more or less, tiles that start on an empty row, empty rows in the
middle and at the tail, no edges, no rows, a row_ptr that does not start
at 0), at the kernel's tile and at small ones
that cut many rows: every slot in exactly one tile, in order; every row
ending in exactly one tile; the rows cut by a tile boundary listed with the
tile of their first slot. The model walks each tile as the kernel's
threads do (a merge-path search per thread, the walk, the block's
segmented scan, the carries and the fixup launch) and must write every row
exactly once with the plain version's value: integer-valued f32, so every
order of the sums gives the same bits. Last, the advance keeps one plan per
direction of a graph.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorgraphlibrary_tpu_torch.apps import make_lj_replica
from vectorgraphlibrary_tpu_torch.config import TraversalDirection as TDir
from vectorgraphlibrary_tpu_torch.graph.device import import_graph
from vectorgraphlibrary_tpu_torch.io import generation
from vectorgraphlibrary_tpu_torch.io.edges_container import EdgesContainer
from vectorgraphlibrary_tpu_torch.ops import advance
from vectorgraphlibrary_tpu_torch.ops.cuda import pull_reduce as pr_mod

THREADS, ITEMS = 256, 5          # csrc/pull_reduce.cu kThreads, kItems
# (threads, items per thread) of the tiles the model runs: the kernel's,
# and small ones that cut every longer row
SHAPES = [(THREADS, ITEMS), (4, 2), (8, 3)]


@functools.lru_cache(maxsize=None)
def _graph_csr(kind, d):
    if kind == "rmat":
        ec = generation.rmat(10, 8, seed=5, weighted=False)
    elif kind == "lj":
        ec = make_lj_replica.replica(3001, 42600, 200)
    else:
        rng = np.random.default_rng(11)
        v, e = 900, 9000
        src = rng.integers(0, v, e).astype(np.int32)
        dst = rng.integers(0, v, e).astype(np.int32)
        src[:50] = dst[:50]                      # self-loops
        if kind == "hub":
            src[:2100], dst[:2100] = rng.integers(0, v, 2100), 3
            src[2100:2700], dst[2100:2700] = 7, rng.integers(0, v, 600)
        ec = EdgesContainer(src_ids=src, dst_ids=dst, vertices_count=v)
    dg = import_graph(ec, device="cpu").direction(
        TDir.GATHER if d == "G" else TDir.SCATTER)
    return dg.row_ptr.numpy(), dg.col_idx.numpy()


def _adversarial_csr(kind, tile):
    """(row_ptr, col_idx) of one adversarial CSR for tiles of `tile`
    items (module doc)."""
    rng = np.random.default_rng(len(kind) + tile)
    base = 0
    if kind == "one row":
        degs = [5000]
    elif kind == "tile rows":
        degs = [tile - 1, tile, tile - 2, 3 * tile - 1, 1, tile + 1, 0,
                tile - 1]
    elif kind == "empty at tile start":
        degs = ([tile - 2] + [0] * 3 + [tile - 4] + [0] * (tile + 5)) * 3
    elif kind == "empty rows":
        degs = rng.choice([0, 0, 0, 1, 2, 7, 40, 300], size=3000)
        degs[-500:] = 0
    elif kind == "no edges":
        degs = [0] * 700
    elif kind == "no rows":
        degs = []
    elif kind == "one edge":
        degs = [1]
    else:                                        # "offset": a slice of a CSR
        degs = rng.choice([0, 1, 3, 50, 2 * tile], size=400)
        base = 123
    rp = (base + np.concatenate([[0], np.cumsum(degs)])).astype(np.int32)
    v = max(len(degs), 1)
    ci = rng.integers(0, v, int(rp[-1]) + 3).astype(np.int32)
    for r in np.flatnonzero(np.asarray(degs) > 2)[:40]:
        ci[rp[r] + 1] = r                        # self-loops
    return rp, ci


ADVERSARIAL = ["one row", "tile rows", "empty at tile start", "empty rows",
               "no edges", "no rows", "one edge", "offset"]
GRAPHS = [(k, d) for k in ("rmat", "selfloops", "hub", "lj")
          for d in ("G", "S")]


def _csr(case, tile):
    if case in ADVERSARIAL:
        return _adversarial_csr(case, tile)
    kind, d = case.split("-")
    return _graph_csr(kind, d)


def _plan(rp, tile, monkeypatch):
    monkeypatch.setattr(pr_mod, "TILE", tile)
    plan = pr_mod.make_plan(torch.from_numpy(rp))
    return plan.tiles.numpy().astype(np.int64), plan.fix.numpy(), plan


def _model(rp, ci, x, threads, items_per, tiles, fix, excl):
    """csrc/pull_reduce.cu's f32 add over the plan, thread by thread
    (pull_reduce_kernel, then pull_reduce_fixup_kernel). Returns the rows'
    values and how many times each row was written."""
    n = rp.shape[0] - 1
    nt = tiles.shape[0] - 1
    out = np.full(n, np.nan)
    written = np.zeros(n, np.int64)
    carry = np.full(2 * nt, np.nan)
    for b in range(nt):
        (r0, k0), (r1, k1) = tiles[b], tiles[b + 1]
        a_len, ns = r1 - r0, k1 - k0
        items = a_len + ns
        s_end = np.append(rp[r0 + 1:r1 + 1].astype(np.int64) - k0, 2**31 - 1)
        msg = x[ci[k0:k1]]
        keys, vals, firsts, last = [], [], [], None
        for t in range(threads):
            d0 = min(t * items_per, items)
            d1 = min(d0 + items_per, items)
            lo, hi = max(0, d0 - ns), min(d0, a_len)
            while lo < hi:
                mid = (lo + hi) // 2
                if s_end[mid] + mid + 1 <= d0:
                    lo = mid + 1
                else:
                    hi = mid
            i, k, acc, first = lo, d0 - lo, 0.0, None
            for _ in range(d0, d1):
                if s_end[i] <= k:
                    if first is None:
                        first = (i, acc)
                    else:
                        out[r0 + i] = acc
                        written[r0 + i] += 1
                    acc, i = 0.0, i + 1
                else:
                    if not (excl and ci[k0 + k] == r0 + i):
                        acc += msg[k]
                    k += 1
            keys.append(i)
            vals.append(acc)
            firsts.append(first)
            if d0 < items and d1 == items:
                last = t
        # the block's segmented inclusive scan over the threads' open rows
        scan = []
        for t in range(threads):
            same = t > 0 and keys[t - 1] == keys[t]
            scan.append(scan[-1] + vals[t] if same else vals[t])
        for t, first in enumerate(firsts):
            if first is None:
                continue
            v = (scan[t - 1] if t else 0.0) + first[1]
            if first[0] == 0 and rp[r0] < k0:
                carry[nt + b] = v                # the head of a cut row
            else:
                out[r0 + first[0]] = v
                written[r0 + first[0]] += 1
        carry[b] = scan[last]
    for b, bs in fix:
        r = tiles[b][0]
        out[r] = carry[bs:b].sum() + carry[nt + b]
        written[r] += 1
    return out, written


def _plain(rp, ci, x, excl):
    n = rp.shape[0] - 1
    out = np.zeros(n)
    for v in range(n):
        ks = np.arange(rp[v], rp[v + 1])
        m = x[ci[ks]]
        if excl:
            m = np.where(ci[ks] == v, 0.0, m)
        out[v] = m.sum()
    return out


CASES = [f"{k}-{d}" for k, d in GRAPHS] + ADVERSARIAL


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", CASES)
def test_plan_covers_every_slot_and_row_once(case, shape, monkeypatch):
    """Slots in tile order, each in exactly one tile; each row's end in
    exactly one tile, the one holding its merge item; the rows cut by a
    boundary listed with the tile of their first slot."""
    tile = shape[0] * shape[1]
    rp, _ = _csr(case, tile)
    tiles, fix, plan = _plan(rp, tile, monkeypatch)
    n, base, e = rp.shape[0] - 1, int(rp[0]), int(rp[-1] - rp[0])
    total = n + e
    assert plan.n_tiles == -(-total // tile) == tiles.shape[0] - 1
    assert tuple(tiles[0]) == (0, base) and tuple(tiles[-1]) == (n, base + e)
    sizes = np.diff(tiles.sum(1))
    assert (sizes == tile).all() if total % tile == 0 else \
        (sizes[:-1] == tile).all() and 0 < sizes[-1] < tile
    # every slot in exactly one tile, in order: the tiles' slot ranges
    # [k_b, k_b+1) are consecutive and cover [rp[0], rp[n])
    assert (np.diff(tiles[:, 1]) >= 0).all() and (np.diff(tiles[:, 0]) >= 0).all()
    slot_tile = np.searchsorted(tiles[:, 1], np.arange(base, base + e),
                                side="right") - 1
    item = np.arange(e) + np.searchsorted(rp[1:], np.arange(base, base + e),
                                          side="right")
    np.testing.assert_array_equal(slot_tile, item // tile)
    # every row ends in exactly one tile: its end item's
    end_item = rp[1:].astype(np.int64) - base + np.arange(n)
    row_tile = np.searchsorted(tiles[:, 0], np.arange(n), side="right") - 1
    np.testing.assert_array_equal(row_tile, end_item // tile)
    # the rows cut by a tile boundary: ending in tile b, first slot before it
    start_item = rp[:-1].astype(np.int64) - base + np.arange(n)
    cut = (rp[1:] > rp[:-1]) & (start_item // tile < end_item // tile)
    want = sorted((int(end_item[r] // tile), int(start_item[r] // tile))
                  for r in np.flatnonzero(cut))
    got = sorted(map(tuple, fix.tolist()))
    assert got == want and plan.n_fix == len(want)
    for b, _ in fix:
        assert tiles[b][1] > rp[tiles[b][0]]     # the head began earlier


@pytest.mark.parametrize("excl", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", CASES)
def test_model_of_the_kernel_writes_every_row_once(case, shape, excl,
                                                   monkeypatch):
    threads, items_per = shape
    tile = threads * items_per
    rp, ci = _csr(case, tile)
    tiles, fix, _ = _plan(rp, tile, monkeypatch)
    x = np.random.default_rng(3).integers(-50, 50, ci.max(initial=0) + 1) \
        .astype(np.float64)
    got, written = _model(rp, ci, x, threads, items_per, tiles, fix, excl)
    np.testing.assert_array_equal(written, 1)
    np.testing.assert_array_equal(got, _plain(rp, ci, x, excl))


@pytest.mark.parametrize("case,tile", [("tile rows", 6), ("empty rows", 6),
                                       ("empty at tile start", 24),
                                       ("one row", THREADS * ITEMS)])
def test_adversarial_csrs_reach_the_edges_they_name(case, tile, monkeypatch):
    """Rows cut by tile boundaries, tiles that start on an empty row, and
    empty rows both between non-empty ones and at the tail."""
    rp, _ = _csr(case, tile)
    tiles, fix, _ = _plan(rp, tile, monkeypatch)
    degs = np.diff(rp)
    assert fix.shape[0] > 0
    if case == "empty at tile start":
        starts = tiles[1:-1, 0]
        assert (degs[starts] == 0).any()
    if case == "empty rows":
        nz = np.flatnonzero(degs)
        assert (degs[nz[0]:nz[-1]] == 0).any() and degs[-1] == 0
    if case == "one row":
        assert tuple(fix[0]) == (tiles.shape[0] - 2, 0)


def test_advance_keeps_one_plan_per_direction(monkeypatch):
    """advance_pull_value and advance_pull make each direction's plan at
    their first pull and reuse it: no plan (and no read of row_ptr back to
    the host) on later calls."""
    made = []

    def counting(row_ptr):
        made.append(row_ptr)
        return pr_mod.make_plan(row_ptr)
    monkeypatch.setattr(advance, "make_plan", counting)
    ec = generation.rmat(9, 8, seed=2, weighted=False)
    g = import_graph(ec, device="cpu")
    x = torch.rand(g.v_pad)
    for _ in range(3):
        for d in (TDir.GATHER, TDir.SCATTER):
            advance.advance_pull_value(g, x, "add", direction=d)
            advance.advance_pull(g, {"x": x}, lambda s, dd, w: s["x"], "max",
                                 direction=d)
    assert len(made) == 2
    assert made[0] is g.incoming.row_ptr and made[1] is g.outgoing.row_ptr
    for dg in (g.incoming, g.outgoing):
        assert advance.pull_plan(dg) is advance.pull_plan(dg)
        assert advance.pull_plan(dg).row_ptr is dg.row_ptr


def test_wrapper_refuses_a_plan_of_another_csr():
    """A plan names the row_ptr it was made for; the kernel's wrapper
    refuses it for another (on the CPU the plain version ignores plans, so
    the check is held on the helper the wrappers share)."""
    rp = torch.tensor([0, 2, 3], dtype=torch.int32)
    plan = pr_mod.make_plan(rp)
    assert pr_mod._launch_plan("pull_reduce", rp, plan)[0] is plan
    with pytest.raises(ValueError):
        pr_mod._launch_plan("pull_reduce", rp.clone(), plan)
