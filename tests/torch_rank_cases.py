"""Inputs, and one rank's side, of the port's collective tests
(test_torch_collectives.py). Every rank rebuilds the same [D, n] inputs from
the seeds and takes its row, as the JAX package's tests give row d to
device d of a shard_map (tests/test_sharded2.py:47-116). This module imports
numpy and, in a rank, the port only: the ranks run no JAX."""
import numpy as np

MERGE_DTYPES = ("float32", "int32")


def merge_all_inputs(d: int, n: int = 256, seed: int = 11) -> dict:
    """name -> (op, [D, n] array) for merge_all: add, min and max over the
    runners' f32 and i32, bool or/min/max (BFS reachability), and or over
    int32 and int8 words with the top bit set."""
    rng = np.random.default_rng(seed)
    out = {}
    for dt in MERGE_DTYPES:
        for op in ("add", "min", "max"):
            if dt == "float32":
                a = rng.normal(size=(d, n)).astype(np.float32)
            else:
                a = rng.integers(-1000, 1000, (d, n)).astype(np.int32)
            out[f"{op}_{dt}"] = (op, a)
    for op in ("or", "min", "max"):
        out[f"{op}_bool"] = (op, rng.random((d, n)) < 0.3)
    out["or_int32"] = ("or", rng.integers(-2**31, 2**31, (d, n),
                                          dtype=np.int64).astype(np.int32))
    out["or_int8"] = ("or", rng.integers(-128, 128, (d, n)).astype(np.int8))
    return out


def exchange_inputs(d: int) -> dict:
    """name -> (op, capacity, prev [n], xs [D, n]) for merge_changed and
    merge_changed_sparse: the JAX package's cases at D ranks."""
    out = {}
    rng = np.random.default_rng(3)
    n = 1024
    for op in ("min", "max", "add", "or"):
        if op == "or":
            prev = rng.random(n) < 0.1
            xs = np.broadcast_to(prev, (d, n)).copy()
            for r in range(d):
                xs[r, rng.integers(0, n, 5)] = True
        else:
            prev = rng.normal(size=n).astype(np.float32)
            xs = np.broadcast_to(prev, (d, n)).copy()
            for r in range(d):               # ~20 changed entries per rank
                idx = rng.integers(0, n, 20)
                xs[r, idx] = rng.normal(size=20).astype(np.float32)
        out[f"sparse_{op}"] = (op, 64, prev, xs)
    rng = np.random.default_rng(5)
    prev = rng.normal(size=512).astype(np.float32)
    xs = np.stack([np.minimum(prev, rng.normal(size=512).astype(np.float32))
                   for _ in range(d)])         # nearly everything changed
    out["overflow_min"] = ("min", 16, prev, xs)
    rng = np.random.default_rng(17)
    n = 1 << 14
    prev = rng.normal(size=n).astype(np.float32)
    xs = np.broadcast_to(prev, (d, n)).copy()
    for r in range(d):                           # 3 changed entries per rank
        idx = rng.integers(0, n, 3)
        xs[r, idx] = prev[idx] - 1.0
    out["tail_min"] = ("min", None, prev, xs)    # capacity: the policy's
    return out


def scatter_inputs(d: int, v_local: int = 64, m: int = 500,
                   seed: int = 23) -> tuple:
    """(values [D, m] f32, global indices [D, m]) for scatter_to_owner: a
    tenth of the indices fall outside every rank's range."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(-v_local // 4, d * v_local + v_local // 4, (d, m))
    return rng.normal(size=(d, m)).astype(np.float32), idx.astype(np.int32)


def collectives_rank(rank: int, world: int, device) -> dict:
    """One rank's results of every case (parallel/launch.run_ranks)."""
    import torch
    from vectorgraphlibrary_tpu_torch.parallel import collectives as C

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    out = {}
    for name, (op, a) in merge_all_inputs(world).items():
        out[f"merge_all/{name}"] = C.merge_all(t(a[rank]), op)
    calls = []
    dense = C.merge_changed

    def counted(*args, **kw):
        calls.append(1)
        return dense(*args, **kw)
    for name, (op, cap, prev, xs) in exchange_inputs(world).items():
        if cap is None:
            cap = C.delta_capacity_policy(len(prev), world)
        out[f"dense/{name}"] = dense(t(xs[rank]), t(prev), op)
        calls.clear()
        C.merge_changed = counted
        try:
            out[f"sparse/{name}"] = C.merge_changed_sparse(
                t(xs[rank]), t(prev), op, cap)
        finally:
            C.merge_changed = dense
        out[f"dense_branch/{name}"] = len(calls)
    v_local = 64
    out["gather_private"] = C.gather_private(
        torch.arange(rank * v_local, (rank + 1) * v_local, device=device))
    vals, idx = scatter_inputs(world, v_local)
    for op in ("add", "min", "max"):
        init = (None if op == "add"
                else torch.full((v_local,), np.inf if op == "min" else -np.inf,
                                device=device))
        out[f"scatter/{op}"] = C.scatter_to_owner(
            t(vals[rank]), t(idx[rank]), v_local, combine=op, init=init)
    return {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in out.items()}
