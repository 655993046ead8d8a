"""PyTorch port, the sorted build of the scatter-combine kernel on the CPU:
scatter_combine_sorted_ref (and the wrapper, which runs it for a CPU
tensor) against the JAX package's `jnp.zeros(n).at[idx].add(bits,
mode="drop")` and the min and max over an identity fill, exactly, with
messages at -1 and at n_out and past it (dropped: JAX would wrap a negative
index, so the JAX side gets those at n_out instead, and the port's result
equals the build without them); the or against numpy; its ValueError on a
decreasing idx; Monoid.scatter_new_sorted against the JAX package's
scatter_at into an identity fill in every case scatter_at_ takes, with the
same errors. The kernel itself runs on the card (tests/test_torch_cuda.py);
models/tc._tc_build_bits, its caller, is held to the JAX package's in
tests/test_torch_tc.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from vectorgraphlibrary_tpu.ops import monoid as jmonoid

from vectorgraphlibrary_tpu_torch.ops import monoid as tmonoid
from vectorgraphlibrary_tpu_torch.ops.cuda import scatter_combine as sc

IDENT = {"add": 0, "or": 0, "min": 2**31 - 1, "max": -2**31}


def _sorted_inputs(seed: int, n_out: int, n: int, kind: str):
    """Non-decreasing int32 indices, a few at -1 (and below) and at n_out
    (and past it), and int32 messages over the full range."""
    rng = np.random.default_rng(seed)
    if kind == "one-word":
        idx = np.full(n, n_out // 2)
    elif kind == "bitmap":          # bits of a [rows, 16] bitmap, hub rows
        rows = n_out // 16
        u = np.sort(np.concatenate([rng.integers(0, rows, n // 2),
                                    rng.integers(0, 3, n - n // 2)]))
        idx = u * 16 + rng.integers(0, 16, n)
    else:
        idx = rng.integers(0, n_out, n)
    if n and kind != "one-word":
        idx[: max(1, n // 20)] = -1
        idx[: max(1, n // 50)] = -5
        idx[-max(1, n // 20):] = n_out
        idx[-max(1, n // 50):] = n_out + 7
    idx = np.sort(idx).astype(np.int32)
    msg = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    return idx, msg


def _jax_want(op: str, n_out: int, idx: np.ndarray, msg) -> np.ndarray:
    """The JAX package's .at[].<op>(mode="drop") into the identity fill,
    with negative indices sent past the end (JAX wraps them); or by numpy."""
    idx = np.where(idx < 0, n_out, idx)
    vals = np.broadcast_to(np.asarray(msg, np.int32), idx.shape)
    if op == "or":
        out = np.zeros(n_out, np.int32)
        keep = idx < n_out
        np.bitwise_or.at(out, idx[keep], vals[keep])
        return out
    base = jnp.full(n_out, IDENT[op], jnp.int32)
    at = base.at[jnp.asarray(idx)]
    return np.asarray(getattr(at, op)(jnp.asarray(vals), mode="drop"))


# (n_out, messages, kind): spans of every density, all messages on one
# word, a bitmap with hub rows, no message at all
CASES = {"dense": (64, 2000, "uniform"), "sparse": (5000, 300, "uniform"),
         "one-word": (1000, 700, "one-word"), "bitmap": (16 * 300, 3000,
                                                         "bitmap"),
         "empty": (100, 0, "uniform"), "ragged": (8193, 9000, "uniform")}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("op", ["add", "or", "min", "max"])
def test_sorted_ref_matches_jax(op, case):
    n_out, n, kind = CASES[case]
    idx, msg = _sorted_inputs(len(case), n_out, n, kind)
    want = _jax_want(op, n_out, idx, msg)
    for fn in (sc.scatter_combine_sorted_ref, sc.scatter_combine_sorted):
        got = fn(n_out, torch.from_numpy(idx), torch.from_numpy(msg), op)
        assert got.dtype == torch.int32 and got.shape == (n_out,)
        np.testing.assert_array_equal(got.numpy(), want)
    # the messages outside [0, n_out) change nothing
    keep = (idx >= 0) & (idx < n_out)
    inside = sc.scatter_combine_sorted_ref(
        n_out, torch.from_numpy(idx[keep]), torch.from_numpy(msg[keep]), op)
    np.testing.assert_array_equal(inside.numpy(), want)


@pytest.mark.parametrize("op", ["add", "or", "min", "max"])
def test_sorted_ref_takes_one_message_for_all(op):
    idx, _ = _sorted_inputs(3, 500, 800, "uniform")
    got = sc.scatter_combine_sorted(500, torch.from_numpy(idx), 3, op)
    np.testing.assert_array_equal(got.numpy(), _jax_want(op, 500, idx, 3))


def test_triangle_bitmap_build_matches_jax_zeros_add():
    """The triangle count's form: one bit per (row, word, bit), sorted by
    row then bit position, added into zeros (add == or)."""
    rng = np.random.default_rng(5)
    rows, words = 400, 8
    key = np.unique(rng.integers(0, rows * words * 32, 5000))
    u, col = key // (words * 32), key % (words * 32)
    idx = (u * words + (col >> 5)).astype(np.int32)
    bit = np.left_shift(np.int32(1), (col & 31).astype(np.int32))
    want = np.asarray(jnp.zeros(rows * words, jnp.int32).at[
        jnp.asarray(idx)].add(jnp.asarray(bit), mode="drop"))
    got = sc.scatter_combine_sorted(rows * words, torch.from_numpy(idx),
                                    torch.from_numpy(bit), "add")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("where", ["start", "middle", "end"])
def test_sorted_ref_refuses_a_decreasing_idx(where):
    idx = np.arange(100, dtype=np.int32)
    i = {"start": 1, "middle": 50, "end": 99}[where]
    idx[i] = idx[i - 1] - 1
    with pytest.raises(ValueError, match="decreases"):
        sc.scatter_combine_sorted_ref(200, torch.from_numpy(idx), 1, "add")
    with pytest.raises(ValueError, match="decreases"):
        tmonoid.ADD.scatter_new_sorted(200, torch.from_numpy(idx),
                                       torch.ones(100, dtype=torch.int32),
                                       torch.int32)


def test_sorted_wrapper_refuses_what_it_does_not_take():
    idx = torch.arange(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        sc.scatter_combine_sorted(8, idx, 1, "xor")
    with pytest.raises(ValueError):
        sc.scatter_combine_sorted_ref(8, idx, 1, "xor")


def test_sorted_span_is_the_kernels():
    """SORTED_SPAN, by which the card's tests place their messages at the
    blocks' boundaries, is the kSpan that csrc/scatter_combine.cu builds."""
    import re
    from pathlib import Path
    src = (Path(sc.__file__).resolve().parents[2] / "csrc"
           / "scatter_combine.cu").read_text()
    spans = re.findall(r"constexpr int kSpan = (\d+);", src)
    assert spans == [str(sc.SORTED_SPAN)]


@pytest.mark.parametrize("name,dtype", [
    ("add", np.int32), ("add", np.float32), ("min", np.int32),
    ("min", np.float32), ("max", np.int32), ("max", np.float32),
    ("any01", np.int32), ("or", np.bool_), ("max", np.bool_)])
def test_monoid_scatter_new_sorted_matches_jax(name, dtype):
    """Monoid.scatter_new_sorted equals the JAX package's Monoid.scatter_at
    into an array of the port monoid's identity, in every case scatter_at_
    takes."""
    n_out = 300
    idx, msg = _sorted_inputs(11, n_out, 1000, "uniform")
    idx = np.sort(np.where(idx < 0, n_out, idx))     # JAX would wrap them
    msg = (msg % 1000).astype(np.int32)        # exact f32 sums
    if name == "any01" or dtype == np.bool_:
        msg = msg > 500
    msg = msg.astype(dtype)
    tdtype = torch.from_numpy(np.zeros(0, dtype)).dtype
    # the port's identity (any01's is 0, the JAX package's the lowest
    # value: both read as False)
    ident = tmonoid.get(name).identity(tdtype).item()
    want = np.asarray(jmonoid.get(name).scatter_at(
        jnp.full(n_out, ident, dtype), jnp.asarray(idx), jnp.asarray(msg),
        mode="drop"))
    got = tmonoid.get(name).scatter_new_sorted(
        n_out, torch.from_numpy(idx), torch.from_numpy(msg), tdtype)
    assert got.dtype == tdtype and got.shape == (n_out,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_scatter_new_sorted_refuses_what_scatter_at_refuses():
    i = torch.arange(4, dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        tmonoid.OR.scatter_new_sorted(4, i, i, torch.int32)
    with pytest.raises(ValueError):
        tmonoid.ADD.scatter_new_sorted(4, i, i, torch.int32, mode="clip")
