"""PyTorch port, routes: the port's route (its plain version on the CPU)
equals the JAX package's fused Pallas route (interpret mode on the CPU)
exactly, over every case of tests/test_route_fused.py:16-118 — k = 10 and 13,
kq > 0 (via _KB_MAX = 3), the outer/inner split (via _KQ_SINGLE_MAX = 2),
finish with add, min, max, mul and none, f32, int32, int8 and bool — in both
directions."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from vectorgraphlibrary_tpu.ops.pallas import route_fused
from vectorgraphlibrary_tpu.ops.route import make_route_plan as jmake_route_plan

from vectorgraphlibrary_tpu_torch.ops.cuda import route_gather as rg
from vectorgraphlibrary_tpu_torch.ops.route import (FinishSpec, apply_route,
                                                    make_route_plan)

NO_FINISH = "no-finish"
# (k, _KB_MAX, _KQ_SINGLE_MAX, dtype, weight_op or NO_FINISH, ident, seed)
CASES = {
    "perm-k10": (10, 12, 8, "f32", NO_FINISH, 0, 7),
    "perm-k13": (13, 12, 8, "f32", NO_FINISH, 0, 7),
    "perm-k13-kq": (13, 3, 8, "f32", NO_FINISH, 0, 7),
    "int32": (10, 12, 8, "i32", NO_FINISH, 0, 3),
    "bool": (10, 12, 8, "bool", NO_FINISH, 0, 3),
    "split": (15, 3, 2, "f32", NO_FINISH, 0, 13),
    "split-finish": (15, 3, 2, "f32", None, -7.0, 13),
    "finish-add": (12, 12, 8, "f32", "add", -5.0, 11),
    "finish-add-kq": (12, 3, 8, "f32", "add", -5.0, 11),
    "finish-none": (12, 12, 8, "f32", None, -5.0, 11),
    "finish-min-kq": (12, 3, 8, "f32", "min", -5.0, 11),
    "finish-max": (12, 12, 8, "f32", "max", -5.0, 11),
    "finish-mul-kq": (12, 3, 8, "f32", "mul", -5.0, 11),
    "int8-finish-add-kq": (12, 3, 8, "i8", "add", 0, 5),
}


def _inputs(rng, n, dtype):
    if dtype == "f32":
        return rng.standard_normal(n).astype(np.float32)
    if dtype == "i32":
        return rng.integers(0, 1 << 30, n).astype(np.int32)
    if dtype == "i8":
        return rng.integers(-128, 128, n).astype(np.int8)
    return rng.integers(0, 2, n).astype(bool)


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("case", list(CASES))
def test_route_matches_jax_fused(case, inverse, monkeypatch):
    k, kb_max, kq_single_max, dtype, wop, ident, seed = CASES[case]
    monkeypatch.setattr(route_fused, "_KB_MAX", kb_max)
    monkeypatch.setattr(route_fused, "_KQ_SINGLE_MAX", kq_single_max)
    n = 1 << k
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    finish = wop != NO_FINISH
    flags_fwd = rng.integers(0, 4, n).astype(np.uint8) if finish else None
    flags_inv = rng.integers(0, 4, n).astype(np.uint8) if finish else None
    x = _inputs(rng, n, dtype)
    w = (_inputs(rng, n, dtype) if finish and wop is not None else None)

    jplan = jmake_route_plan(perm, flags_fwd=flags_fwd, flags_inv=flags_inv)
    assert (jplan.big_words is not None) == (k - 7 > kb_max)
    tplan = make_route_plan(perm, flags_fwd=flags_fwd, flags_inv=flags_inv,
                            device="cpu")
    jfin = tfin = None
    if finish:
        jfin = route_fused.FinishSpec(ident=ident, exclude_self_loops=True,
                                      weight_op=wop)
        tfin = FinishSpec(ident=ident, exclude_self_loops=True, weight_op=wop)
    want = np.asarray(route_fused.apply_route_fused(
        jplan, jnp.asarray(x), inverse=inverse, finish=jfin,
        weights=None if w is None else jnp.asarray(w)))
    got = apply_route(tplan, torch.from_numpy(x), inverse=inverse,
                      finish=tfin,
                      weights=None if w is None else torch.from_numpy(w))
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    if not finish:          # and both are the permutation itself
        inv = np.empty_like(x)
        inv[perm] = x
        np.testing.assert_array_equal(got.numpy(), inv if inverse else x[perm])


def test_make_route_plan_rejects_non_permutations():
    with pytest.raises(ValueError):
        make_route_plan(np.array([0, 0, 1, 2]), device="cpu")
    with pytest.raises(ValueError):
        make_route_plan(np.array([0, 1, 2, 4]), device="cpu")


def test_wrapper_argument_checks():
    x = torch.arange(8, dtype=torch.float32)
    idx = torch.arange(8, dtype=torch.int32).flip(0)
    with pytest.raises(ValueError):
        rg.route_gather_finish(x, idx, weight_op="sub", weights=x)
    with pytest.raises(ValueError):
        rg.route_gather_finish(x, idx, weights=x)
    assert torch.equal(rg.route_gather_finish(x, idx), x.flip(0))


@pytest.mark.parametrize("finish", [False, True], ids=["plain", "finish"])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_bool_route_equals_cast_path(inverse, finish):
    """apply_route moves a bool vector as its bytes (a view): the result is
    what the cast path gave (to int8 before the route, back to bool after it
    without a finish; int8 with one)."""
    rng = np.random.default_rng(9)
    n = 1 << 10
    flags = rng.integers(0, 4, (2, n)).astype(np.uint8)
    plan = make_route_plan(rng.permutation(n), flags_fwd=flags[0],
                           flags_inv=flags[1], device="cpu")
    x = torch.from_numpy(rng.random(n) < 0.3)
    x0 = x.clone()
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
    assert torch.equal(x, x0)           # a view of the input, not changed
