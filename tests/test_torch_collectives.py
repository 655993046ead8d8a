"""PyTorch port, the collectives (parallel/collectives.py) on 4 gloo ranks
on the CPU against the JAX package's on 4 devices of the virtual CPU mesh:
merge_all over the runners' types (f32 and i32 add, min and max; bool or,
min and max; or over int32 and int8 words with the top bit set, an
unsigned max), merge_changed and merge_changed_sparse on the cases of
tests/test_sharded2.py:47-116 (both branches: the sparse one within
capacity, the dense one when a rank overflows it), gather_private and
scatter_to_owner; delta_capacity_policy equal to the reference's."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map

from vectorgraphlibrary_tpu.parallel import collectives as JC
from vectorgraphlibrary_tpu.parallel.mesh import make_mesh as jmake_mesh

from tests import torch_rank_cases as cases
from vectorgraphlibrary_tpu_torch.parallel import collectives as C
from vectorgraphlibrary_tpu_torch.parallel.launch import run_ranks

D = 4


@pytest.fixture(scope="module")
def ranks():
    return run_ranks("tests.torch_rank_cases:collectives_rank", D,
                     device="cpu", timeout=120)


@functools.lru_cache(maxsize=None)
def _jmesh():
    return jmake_mesh(D, 1, jax.devices()[:D])


def _jax_run(fn, xs, prev=None):
    """fn(x_row[, prev]) over the D-device mesh; the replicated result."""
    if prev is None:
        body = shard_map(lambda x: fn(x[0]), mesh=_jmesh(),
                         in_specs=(P("e"),), out_specs=P(), check_rep=False)
        return np.asarray(jax.jit(body)(jnp.asarray(xs)))
    body = shard_map(lambda x, p: fn(x[0], p), mesh=_jmesh(),
                     in_specs=(P("e"), P()), out_specs=P(), check_rep=False)
    return np.asarray(jax.jit(body)(jnp.asarray(xs), jnp.asarray(prev)))


def _numpy_merge(op, a):
    if op == "add":
        return a.sum(axis=0, dtype=a.dtype)
    if op == "min":
        return a.min(axis=0)
    if op == "max":
        return a.max(axis=0)
    if a.dtype == np.bool_:
        return a.any(axis=0)
    u = a.view({np.int8: np.uint8, np.int32: np.uint32}[a.dtype.type])
    return u.max(axis=0).view(a.dtype)


@pytest.mark.parametrize("name", list(cases.merge_all_inputs(D)))
def test_merge_all(ranks, name):
    op, a = cases.merge_all_inputs(D)[name]
    want = _numpy_merge(op, a)
    for r in ranks:
        got = r[f"merge_all/{name}"]
        assert got.dtype == a.dtype and got.shape == a.shape[1:]
        if a.dtype == np.float32 and op == "add":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)
    if a.dtype != np.bool_:
        jwant = _jax_run(lambda x: JC.merge_all(x, op), a)
        np.testing.assert_allclose(ranks[0][f"merge_all/{name}"], jwant,
                                   rtol=1e-6, atol=1e-6)


def test_or_is_an_unsigned_max(ranks):
    """Words with bit 31 set order above every other word: a signed MAX
    would keep 1 over 0x80000000."""
    _, a = cases.merge_all_inputs(D)["or_int32"]
    got = ranks[0]["merge_all/or_int32"]
    assert (got < 0).sum() > 0
    assert (got.view(np.uint32) >= a.view(np.uint32)).all()


@pytest.mark.parametrize("name", list(cases.exchange_inputs(D)))
def test_merge_changed_dense_and_sparse(ranks, name):
    op, cap, prev, xs = cases.exchange_inputs(D)[name]
    if cap is None:
        cap = JC.delta_capacity_policy(len(prev), D)
        assert cap == C.delta_capacity_policy(len(prev), D)
        assert cap <= len(prev) // 32
    jdense = _jax_run(lambda x, p: JC.merge_changed(x, p, op), xs, prev)
    jsparse = _jax_run(lambda x, p: JC.merge_changed_sparse(x, p, op, cap),
                       xs, prev)
    # the dense branch runs exactly when a rank's delta overflows
    overflow = int((xs != prev).sum(axis=1).max()) > cap
    assert overflow == (name == "overflow_min")
    for r in ranks:
        assert int(r[f"dense_branch/{name}"]) == int(overflow)
        for key, want in ((f"dense/{name}", jdense),
                          (f"sparse/{name}", jsparse),
                          (f"sparse/{name}", r[f"dense/{name}"])):
            got = r[key]
            assert got.dtype == prev.dtype
            if op == "add":
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
            else:
                np.testing.assert_array_equal(got, want)
    if op == "min":
        np.testing.assert_array_equal(ranks[0][f"sparse/{name}"],
                                      np.minimum(prev, xs.min(axis=0)))


def test_gather_private(ranks):
    for r in ranks:
        np.testing.assert_array_equal(r["gather_private"], np.arange(D * 64))


@pytest.mark.parametrize("op", ["add", "min", "max"])
def test_scatter_to_owner(ranks, op):
    v_local = 64
    vals, idx = cases.scatter_inputs(D, v_local)
    for rank, r in enumerate(ranks):
        init = {"add": 0.0, "min": np.inf, "max": -np.inf}[op]
        want = np.full(v_local, init, np.float32)
        local = idx[rank].astype(np.int64) - rank * v_local
        keep = (local >= 0) & (local < v_local)
        ufunc = {"add": np.add, "min": np.minimum, "max": np.maximum}[op]
        ufunc.at(want, local[keep], vals[rank][keep])
        np.testing.assert_allclose(r[f"scatter/{op}"], want, rtol=1e-6,
                                   atol=1e-6)


def test_delta_capacity_policy():
    """The reference's values (tests/test_sharded2.py) and its function on
    a grid of sizes, rank counts and requests."""
    n = 1 << 20
    assert C.delta_capacity_policy(n, 8) == n // 64
    assert C.delta_capacity_policy(n, 8, requested=n) == n // 32
    assert C.delta_capacity_policy(n, 8, requested=128) == 128
    assert C.delta_capacity_policy(n, 64) == n // 256
    assert C.delta_capacity_policy(256, 64) == 64
    for n in (256, 1 << 14, 1 << 20):
        for d in (1, 2, 4, 8, 64):
            for req in (None, 16, 1 << 12, n):
                assert C.delta_capacity_policy(n, d, req) == \
                    JC.delta_capacity_policy(n, d, req)


def test_merges_refuse_what_they_cannot_merge():
    x = torch.zeros(4)
    with pytest.raises(ValueError):
        C.merge_all(x, "xor")
    with pytest.raises(ValueError):
        C.merge_all(x, "or")              # float words
    with pytest.raises(ValueError):
        C.merge_all(torch.zeros(4, dtype=torch.int64), "or")
    with pytest.raises(ValueError):
        C.merge_changed(x, x, "xor")
    with pytest.raises(ValueError):
        C.merge_changed_sparse(x, x, "xor", 8)
