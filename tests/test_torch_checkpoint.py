"""PyTorch port, checkpoint/resume (runtime/checkpoint.py): the JAX
package's four cases (tests/test_checkpoint.py) on torch tensors, and a
file saved by either package loads in the other with `like`."""
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from vectorgraphlibrary_tpu.runtime import checkpoint as jck
from vectorgraphlibrary_tpu_torch.runtime import checkpoint as ck


def test_save_load_roundtrip(tmp_path):
    state = {"ranks": torch.arange(10, dtype=torch.float32),
             "it": torch.tensor(7, dtype=torch.int32),
             "nested": (torch.ones(3), torch.zeros(2, dtype=torch.int32))}
    p = str(tmp_path / "s.npz")
    ck.save_state(p, 42, state)
    step, got = ck.load_state(p, like=state)
    assert step == 42
    np.testing.assert_array_equal(got["ranks"],
                                  np.arange(10, dtype=np.float32))
    assert int(got["it"]) == 7 and got["it"].dtype == torch.int32
    np.testing.assert_array_equal(got["nested"][1], np.zeros(2, np.int32))
    assert isinstance(got["nested"], tuple)
    step, flat = ck.load_state(p)
    assert step == 42 and all(t.device.type == "cpu" for t in flat)
    assert [t.numel() for t in flat] == [1, 3, 2, 10]   # keys sorted


def test_manager_cadence_prune_restore(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path / "ck"), every_n=2, keep=2)
    for step in range(7):
        wrote = mgr.maybe_save(step, {"x": torch.full((4,), float(step))})
        assert wrote == (step % 2 == 0)
    assert mgr._steps() == [4, 6]                 # pruned to last 2
    step, state = mgr.restore_latest(like={"x": torch.zeros(4)})
    assert step == 6
    np.testing.assert_array_equal(state["x"], np.full(4, 6.0))


def test_restore_skips_corrupt(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path / "ck"), every_n=1, keep=3)
    mgr.maybe_save(1, {"x": torch.ones(2)})
    mgr.maybe_save(2, {"x": torch.full((2,), 2.0)})
    with open(mgr.path(3), "wb") as f:                 # truncated garbage
        f.write(b"not an npz")
    step, state = mgr.restore_latest(like={"x": torch.zeros(2)})
    assert step == 2
    np.testing.assert_array_equal(state["x"], np.full(2, 2.0))


def test_run_with_checkpoints_resume(tmp_path):
    d = str(tmp_path / "ck")

    def body(step, s):
        return {"x": s["x"] + 1.0}

    mgr = ck.CheckpointManager(d, every_n=2, keep=5)
    # crash after 5 steps (simulate by running only 5)
    last, s = ck.run_with_checkpoints(body, {"x": torch.zeros(1)}, 5, mgr)
    assert float(s["x"][0]) == 5.0
    # fresh manager resumes from step 4's snapshot and completes to 10
    mgr2 = ck.CheckpointManager(d, every_n=2, keep=5)
    last2, s2 = ck.run_with_checkpoints(body, {"x": torch.zeros(1)}, 10, mgr2)
    assert last2 == 10
    assert float(s2["x"][0]) == 10.0             # 5 (restored) + remaining


class Pair(NamedTuple):
    dist: object
    active: object


def _state(arange, ones, zeros, i32, f32, b):
    return {"ranks": arange(6, dtype=f32) / 6,
            "it": ones((), dtype=i32) * 9,
            "pair": Pair(dist=zeros(4, dtype=i32) - 3,
                         active=arange(4, dtype=i32) % 2 == 0),
            "hist": [ones(2, dtype=f32), zeros(3, dtype=b)],
            "none": None}


def _torch_state():
    return _state(torch.arange, torch.ones, torch.zeros, torch.int32,
                  torch.float32, torch.bool)


def _jax_state():
    return _state(jnp.arange, jnp.ones, jnp.zeros, jnp.int32, jnp.float32,
                  jnp.bool_)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [np.asarray(tree)]


@pytest.mark.parametrize("saver", ["jax", "torch"])
def test_files_load_across_packages(tmp_path, saver):
    p = str(tmp_path / "s.npz")
    if saver == "jax":
        jck.save_state(p, 11, _jax_state())
        step, got = ck.load_state(p, like=_torch_state())
        assert isinstance(got["pair"], Pair) and got["none"] is None
        assert all(isinstance(t, torch.Tensor) for t in got["pair"])
        want = _jax_state()
    else:
        ck.save_state(p, 11, _torch_state())
        step, got = jck.load_state(p, like=_jax_state())
        want = _torch_state()
    assert step == 11
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w) == 6
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_load_wrong_template_raises(tmp_path):
    p = str(tmp_path / "s.npz")
    ck.save_state(p, 1, {"x": torch.ones(2), "y": torch.ones(1)})
    with pytest.raises(ValueError, match="2 leaves, template has 1"):
        ck.load_state(p, like={"x": torch.ones(2)})
