"""Algorithm-state checkpoint / resume (port of
vectorgraphlibrary_tpu/runtime/checkpoint.py).

The reference persists only preprocessed graphs and has no algorithm-state
checkpointing (SURVEY §5). This module snapshots a tree of tensors (the
iteration state of PR / SSSP / CC or a GNN train step) to one .npz with its
structure, and resumes from it. The file layout is the JAX package's, so
either package reads the other's files: `leaf_<i>` arrays in flattening
order and a `__meta__` JSON record (`step`, `treedef`, `n_leaves`).

- Trees are dicts (flattened in sorted key order, as jax.tree_util does),
  lists, tuples and NamedTuples; every other value is a leaf (a tensor, a
  numpy array or a Python scalar). None is an empty subtree, as in JAX.
- Saving copies the leaves to the host and writes atomically (tmp +
  rename), so a preempted writer never leaves a truncated checkpoint.
- `CheckpointManager` keeps the last `keep` snapshots, restores the newest
  readable one, and tolerates killed writers.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import zipfile
from typing import Any, List, Optional, Tuple

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree: Any, leaves: List[Any]) -> str:
    """Appends tree's leaves to `leaves`; returns a description of its
    structure."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        keys = sorted(tree)
        return "{" + ", ".join(f"{k!r}: {_flatten(tree[k], leaves)}"
                               for k in keys) + "}"
    if _is_namedtuple(tree):
        return type(tree).__name__ + "(" + ", ".join(
            _flatten(v, leaves) for v in tree) + ")"
    if isinstance(tree, list):
        return "[" + ", ".join(_flatten(v, leaves) for v in tree) + "]"
    if isinstance(tree, tuple):
        inner = [_flatten(v, leaves) for v in tree]
        return "(" + ", ".join(inner) + ("," if len(inner) == 1 else "") + ")"
    leaves.append(tree)
    return "*"


def _unflatten(like: Any, it) -> Any:
    """`like`'s structure with its leaves taken in order from `it`, each
    loaded onto the device of the leaf it replaces."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], it) for k in sorted(like)}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(v, it) for v in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, it) for v in like)
    arr = next(it)
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(like.device)
    return torch.from_numpy(np.array(arr))


def _to_host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_state(path: str, step: int, state: Any) -> None:
    """Snapshot a tree of tensors/arrays/scalars to `path` (.npz),
    atomically."""
    leaves: List[Any] = []
    treedef = _flatten(state, leaves)
    payload = {f"leaf_{i}": _to_host(x) for i, x in enumerate(leaves)}
    payload["__meta__"] = np.frombuffer(json.dumps({
        "step": int(step),
        "treedef": f"PyTreeDef({treedef})",
        "n_leaves": len(leaves),
    }).encode(), dtype=np.uint8)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez(tmp, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_state(path: str, like: Any = None) -> Tuple[int, Any]:
    """Load (step, state). `like`: a tree of the same structure; the result
    has its containers, and each leaf is a tensor on the device of the
    matching leaf of `like` (the CPU where that leaf is no tensor). Without
    `like`, a flat list of CPU tensors."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
        leaves = [z[f"leaf_{i}"] for i in range(meta["n_leaves"])]
    if like is not None:
        template: List[Any] = []
        _flatten(like, template)
        if len(template) != len(leaves):
            raise ValueError(
                f"checkpoint has {len(leaves)} leaves, template has "
                f"{len(template)}")
        return meta["step"], _unflatten(like, iter(leaves))
    return meta["step"], [torch.from_numpy(np.array(a)) for a in leaves]


_CKPT_RE = re.compile(r"^ckpt_(\d+)\.npz$")


class CheckpointManager:
    """Directory of rolling ckpt_<step>.npz snapshots."""

    def __init__(self, directory: str, every_n: int = 10, keep: int = 3):
        self.directory = directory
        self.every_n = max(int(every_n), 1)
        self.keep = max(int(keep), 1)
        os.makedirs(directory, exist_ok=True)

    def _steps(self):
        out = []
        for name in os.listdir(self.directory):
            m = _CKPT_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.npz")

    def maybe_save(self, step: int, state: Any) -> bool:
        """Save when `step` hits the cadence; prunes old snapshots. Returns
        whether a snapshot was written."""
        if step % self.every_n != 0:
            return False
        save_state(self.path(step), step, state)
        for old in self._steps()[:-self.keep]:
            try:
                os.unlink(self.path(old))
            except OSError:
                pass
        return True

    def restore_latest(self, like: Any = None) -> Optional[Tuple[int, Any]]:
        """(step, state) of the newest readable snapshot, or None."""
        for step in reversed(self._steps()):
            try:
                return load_state(self.path(step), like=like)
            except (OSError, ValueError, KeyError, EOFError,
                    zipfile.BadZipFile):          # unreadable or truncated
                continue
        return None


def run_with_checkpoints(body, state: Any, n_steps: int,
                         manager: CheckpointManager,
                         start_step: int = 0) -> Tuple[int, Any]:
    """Host-stepped fixpoint loop with checkpointing: resumes from the
    manager's newest snapshot (if any), runs `state = body(step, state)` for
    the remaining steps, snapshotting on cadence; returns (last_step + 1,
    state)."""
    restored = manager.restore_latest(like=state)
    if restored is not None:
        start_step, state = restored
        start_step += 1
    step = start_step
    for step in range(start_step, n_steps):
        state = body(step, state)
        manager.maybe_save(step, state)
    return (step + 1 if n_steps > start_step else start_step), state
