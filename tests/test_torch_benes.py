"""PyTorch port, Beneš routes: the port's router equals the JAX package's
native router exactly; its word-mask packing equals the JAX one and its
inverse gives the inputs back; the lane shuffle's plain version (the K3
kernel's CPU path) equals the JAX package's CPU lane shuffle; and the
stage-by-stage route equals JAX `apply_route` on the JAX plan of the same
permutation, in both directions, with the gather indices it recovers equal
to perm and argsort(perm)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from vectorgraphlibrary_tpu import native as jnative
from vectorgraphlibrary_tpu.ops import route as jroute
from vectorgraphlibrary_tpu.ops.pallas import route_fused

from vectorgraphlibrary_tpu_torch import native
from vectorgraphlibrary_tpu_torch.ops import route, route_words
from vectorgraphlibrary_tpu_torch.ops.cuda import lane_shuffle as ls


def _perm(k: int) -> np.ndarray:
    return np.random.default_rng(k).permutation(1 << k)


def _inputs(rng, shape, dtype):
    if dtype == "f32":
        return rng.standard_normal(shape).astype(np.float32)
    if dtype == "i32":
        return rng.integers(-2**31, 2**31 - 1, shape,
                            dtype=np.int64).astype(np.int32)
    return rng.integers(-128, 128, shape).astype(np.int8)


@pytest.mark.parametrize("k", [8, 11, 14])
def test_router_equals_jax_router(k):
    got = native.benes_route(_perm(k))
    want = jnative.benes_route(_perm(k))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_router_rejects_bad_input():
    with pytest.raises(ValueError):
        native.benes_route(np.arange(96))
    with pytest.raises(ValueError):
        native.benes_route(np.zeros(256, np.int64))
    with pytest.raises(ValueError):
        native.benes_route(np.arange(256) + 1)


@pytest.mark.parametrize("flags", [False, True], ids=["no-flags", "flags"])
@pytest.mark.parametrize("k", [10, 14, 18])
def test_word_masks_equal_jax_and_unpack(k, flags):
    """n = 2^10 and 2^14 pack every level into mid_words (kq = 0, flags on
    mid); n = 2^18 has kq = 1 (big_words, flags on big)."""
    n = 1 << k
    rng = np.random.default_rng(k)
    in_m, out_m, lane = native.benes_route(_perm(k))
    lane2d = lane.reshape(-1, 128)
    ff = rng.integers(0, 4, n).astype(np.uint8) if flags else None
    fi = rng.integers(0, 4, n).astype(np.uint8) if flags else None
    got = route_words.build_word_masks(in_m, out_m, n, lane_fwd=lane2d,
                                       flags_fwd=ff, flags_inv=fi)
    want = route_fused.build_word_masks(in_m, out_m, n, lane_fwd=lane2d,
                                        flags_fwd=ff, flags_inv=fi)
    assert route_words.split_levels(n) == route_fused.split_levels(n)
    assert (got[1] is None) == (route_words.split_levels(n)[1] == 0)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    u_in, u_out, u_lane, u_ff, u_fi = route_words.unpack_word_masks(*got, n)
    np.testing.assert_array_equal(u_in, in_m)
    np.testing.assert_array_equal(u_out, out_m)
    np.testing.assert_array_equal(u_lane, lane2d)
    zeros = np.zeros(n, np.uint8)
    np.testing.assert_array_equal(u_ff, ff if flags else zeros)
    np.testing.assert_array_equal(u_fi, fi if flags else zeros)


@pytest.mark.parametrize("dtype", ["f32", "i32", "i8"])
def test_lane_shuffle_plain_equals_jax_cpu_path(dtype):
    rng = np.random.default_rng(5)
    x = _inputs(rng, (64, 128), dtype)
    idx = np.argsort(rng.random((64, 128)), axis=1).astype(np.int32)
    idx[3] = 7                                  # repeated indices are allowed
    want = np.asarray(jroute._lane_shuffle(jnp.asarray(x), jnp.asarray(idx)))
    got = ls.lane_shuffle(torch.from_numpy(x), torch.from_numpy(idx))
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    assert ls.lane_shuffle.launches == 0


@pytest.mark.parametrize("bad", ["width", "idx-dtype", "idx-shape",
                                 "x-dtype"])
def test_lane_shuffle_argument_checks(bad):
    x = torch.zeros(2, 128)
    idx = torch.zeros(2, 128, dtype=torch.int32)
    args = {"width": (torch.zeros(2, 64), idx[:, :64]),
            "idx-dtype": (x, idx.long()),
            "idx-shape": (x, idx[:1]),
            "x-dtype": (x.double(), idx)}[bad]
    with pytest.raises((TypeError, ValueError)):
        ls.lane_shuffle(*args)


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("dtype", ["f32", "i32", "i8"])
@pytest.mark.parametrize("k", [8, 11])
def test_stage_route_equals_jax_apply_route(k, dtype, inverse):
    """JAX's stage-by-stage path (fused=False: the plan has no words), the
    case table of tests/test_route.py:17-30."""
    perm = _perm(k)
    jplan = jroute.make_route_plan(perm, fused=False)
    bplan = route.make_benes_plan(perm, device="cpu")
    for f in ("in_masks", "out_masks", "lane_idx", "lane_inv"):
        np.testing.assert_array_equal(getattr(bplan, f).numpy(),
                                      np.asarray(getattr(jplan, f)))
    assert (bplan.n, bplan.levels) == (jplan.n, jplan.levels)
    x = _inputs(np.random.default_rng(k + 1), 1 << k, dtype)
    want = np.asarray(jroute.apply_route(jplan, jnp.asarray(x),
                                         inverse=inverse))
    got = route.apply_route_stages(bplan, torch.from_numpy(x),
                                   inverse=inverse).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    inv = np.empty_like(x)
    inv[perm] = x
    np.testing.assert_array_equal(got, inv if inverse else x[perm])


@pytest.mark.parametrize("k", [8, 11, 13])
def test_plan_from_benes_recovers_perm(k):
    perm = _perm(k)
    rng = np.random.default_rng(k)
    ff = rng.integers(0, 4, 1 << k).astype(np.uint8)
    plan = route.plan_from_benes(route.make_benes_plan(perm, device="cpu"),
                                 flags_fwd=ff, device="cpu")
    want = route.make_route_plan(perm, flags_fwd=ff, device="cpu")
    assert plan.n == want.n and plan.flags_inv is None
    for f in ("fwd_idx", "inv_idx", "flags_fwd"):
        a, b = getattr(plan, f), getattr(want, f)
        assert a.dtype == b.dtype
        assert torch.equal(a, b), f
    np.testing.assert_array_equal(plan.inv_idx.numpy(), np.argsort(perm))


def test_plan_from_benes_rejects_a_corrupt_plan():
    bplan = route.make_benes_plan(_perm(10), device="cpu")
    lanes = bplan.lane_inv.clone()
    lanes[0, :2] = lanes[0, :2].flip(0)     # a valid shuffle, the wrong one
    with pytest.raises(ValueError):
        route.plan_from_benes(dataclasses.replace(bplan, lane_inv=lanes),
                              device="cpu")
