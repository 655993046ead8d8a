"""PyTorch port, the in-place scatter and the feature-row pull's schedule on
the CPU: scatter_combine_ref_ (scatter_combine_'s plain version) and
Monoid.scatter_at_ against the JAX package's `target.at[idx].add/min/max(
vals, mode="drop")` (Monoid.scatter_at), exactly, each writing into its
target and returning it; ops/cuda/pull_rows.schedule covering every row
once, in order, with each warp's share bounded, and `lanes` giving the
widest lanes that F and x's alignment allow. The kernels themselves run on the
card (tests/test_torch_cuda.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from vectorgraphlibrary_tpu.ops import monoid as jmonoid

from vectorgraphlibrary_tpu_torch.ops import monoid as tmonoid
from vectorgraphlibrary_tpu_torch.ops.cuda import pull_rows as prw
from vectorgraphlibrary_tpu_torch.ops.cuda import scatter_combine as sc


def _inputs(seed: int, n_out: int, n: int, dtype):
    """Targets and messages (integer-valued, so an f32 add is exact in any
    order), indices with duplicates and an eighth past either end."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n_out, n)
    idx[rng.random(n) < 1 / 8] = n_out + 3
    idx[: n // 16] = rng.integers(0, 3, n // 16)           # collisions
    out = rng.integers(-1000, 1000, n_out).astype(dtype)
    msg = rng.integers(-1000, 1000, n).astype(dtype)
    return out, idx.astype(np.int32), msg


@pytest.mark.parametrize("seed,n_out,n", [(0, 64, 200), (1, 1 << 12, 1 << 10),
                                          (2, 5, 0), (3, 1000, 4000)])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("op", ["add", "min", "max"])
def test_scatter_combine_ref_in_place_matches_jax(op, dtype, seed, n_out, n):
    out, idx, msg = _inputs(seed, n_out, n, dtype)
    want = np.asarray(jmonoid.get(op).scatter_at(
        jnp.asarray(out), jnp.asarray(idx), jnp.asarray(msg), mode="drop"))
    target = torch.from_numpy(out.copy())
    got = sc.scatter_combine_ref_(target, torch.from_numpy(idx),
                                  torch.from_numpy(msg), op)
    assert got is target
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    # the copying form leaves its target alone and gives the same
    again = torch.from_numpy(out.copy())
    copy = sc.scatter_combine(again, torch.from_numpy(idx),
                              torch.from_numpy(msg), op)
    np.testing.assert_array_equal(again.numpy(), out)
    np.testing.assert_array_equal(copy.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name,dtype", [
    ("add", np.int32), ("add", np.float32), ("min", np.int32),
    ("min", np.float32), ("max", np.int32), ("max", np.float32),
    ("any01", np.int32), ("or", np.bool_), ("max", np.bool_)])
def test_monoid_scatter_at_in_place_matches_jax(name, dtype, seed):
    """Monoid.scatter_at_ equals the JAX package's Monoid.scatter_at (and
    the port's scatter_at) in every case scatter_at takes, writing into its
    target."""
    out, idx, msg = _inputs(seed, 300, 1000, np.int32)
    if name == "any01" or dtype == np.bool_:
        out, msg = out > 500, msg > 0
        if dtype != np.bool_:
            out, msg = out.astype(dtype), msg.astype(dtype)
    else:
        out, msg = out.astype(dtype), msg.astype(dtype)
    want = np.asarray(jmonoid.get(name).scatter_at(
        jnp.asarray(out), jnp.asarray(idx), jnp.asarray(msg), mode="drop"))
    mon = tmonoid.get(name)
    target = torch.from_numpy(out.copy())
    got = mon.scatter_at_(target, torch.from_numpy(idx),
                          torch.from_numpy(msg))
    assert got is target
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        mon.scatter_at(torch.from_numpy(out), torch.from_numpy(idx),
                       torch.from_numpy(msg)).numpy(), want)


def test_scatter_at_in_place_refuses_what_scatter_at_refuses():
    t = torch.zeros(4, dtype=torch.int32)
    i = torch.arange(4, dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        tmonoid.OR.scatter_at_(t, i, i)
    with pytest.raises(ValueError):
        tmonoid.ADD.scatter_at_(t, i, i, mode="clip")
    with pytest.raises(ValueError):
        sc.scatter_combine_ref_(t, i, i, "xor")


def _row_ptr(degs) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(degs)]).astype(np.int64)


def _degrees(kind: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "empty":
        return np.zeros(0, np.int64)
    if kind == "no-edges":
        return np.zeros(50, np.int64)
    if kind == "uniform":
        return rng.integers(0, 40, 5000)
    if kind == "power-law":        # sorted descending, as a GATHER CSR
        return np.sort((rng.pareto(1.2, 20000) * 3).astype(np.int64)
                       .clip(0, 60000))[::-1]
    if kind == "hubs-scattered":   # as a transposed CSR
        d = rng.integers(0, 20, 8000)
        d[rng.choice(8000, 40, replace=False)] = rng.integers(
            prw.HUB_MIN + 1, 30000, 40)
        return d
    if kind == "all-hubs":
        return np.full(30, prw.HUB_MIN + 5)
    raise ValueError(kind)


@pytest.mark.parametrize("n_blocks", [1, 3, 132])
@pytest.mark.parametrize("kind", ["empty", "no-edges", "uniform", "power-law",
                                  "hubs-scattered", "all-hubs"])
def test_schedule_covers_every_row_once_in_order(kind, n_blocks):
    degs = _degrees(kind, n_blocks)
    rp = _row_ptr(degs)
    n = len(degs)
    s = prw.schedule(rp, n_blocks)
    warps = n_blocks * prw.WARPS
    for a in s:
        assert a.dtype == np.int32
    # hubs: every row of more than HUB_MIN edges, each in one block
    hubs = np.flatnonzero(degs > prw.HUB_MIN)
    assert sorted(s.hub_rows.tolist()) == hubs.tolist()
    assert s.blk_hub.shape == (n_blocks + 1,) and s.blk_hub[0] == 0
    assert s.blk_hub[-1] == len(hubs) and (np.diff(s.blk_hub) >= 0).all()
    # parts: hub-free row ranges in row order, warp after warp
    assert s.warp_part.shape == (warps + 1,) and s.warp_part[0] == 0
    assert s.warp_part[-1] == len(s.parts)
    assert (np.diff(s.warp_part) >= 0).all()
    cover = np.zeros(n, np.int64)
    last = 0
    for lo, hi in s.parts:
        assert last <= lo < hi <= n
        assert not (degs[lo:hi] > prw.HUB_MIN).any()
        cover[lo:hi] += 1
        last = hi
    cover[s.hub_rows] += 1
    assert (cover == 1).all()
    # each warp's share: at most its block's even share plus one row
    if n:
        work = np.array([sum(rp[hi] - rp[lo] + hi - lo for lo, hi in
                             s.parts[s.warp_part[q]:s.warp_part[q + 1]])
                         for q in range(warps)])
        hub_w = (degs[hubs] + 1).sum()
        even = ((degs + 1).sum() - hub_w + hub_w) / warps
        row_max = int((np.where(degs > prw.HUB_MIN, 0, degs) + 1).max())
        assert work.max() <= even + row_max + 1


@pytest.mark.parametrize("f,align,vec,cv,chunks", [
    (1, 16, 1, 1, 1), (3, 16, 1, 3, 1), (32, 16, 4, 8, 1),
    (100, 16, 4, 25, 1), (100, 8, 2, 25, 2), (100, 4, 1, 25, 4),
    (256, 16, 4, 32, 2), (256, 8, 2, 32, 4), (256, 4, 1, 32, 8),
    (47, 16, 1, 24, 2), (200, 16, 4, 25, 2)])
def test_lanes_follow_f_and_alignment(f, align, vec, cv, chunks):
    """The widest lanes, at most VEC floats, that F and the alignment allow,
    and F in equal chunks of at most 32 lanes; an address OR-ed with a
    larger power of two than `align` changes nothing."""
    assert prw.lanes(f, align) == (vec, cv, chunks)
    assert prw.lanes(f, align | (align << 5)) == (vec, cv, chunks)
    assert chunks * cv * vec >= f > (chunks * cv - chunks) * vec
