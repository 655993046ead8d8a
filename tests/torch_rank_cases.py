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


def ranks2_rank(rank: int, world: int, device, scale: int, degree: int,
                seed: int, source: int, hub: int, roots: list,
                words: int) -> dict:
    """One rank of test_torch_sharded_ranks2.py: its own shard of the
    weighted RMAT graph, then the five rank drivers of distribution part 2,
    and the coloring's banned-color word of a fixed coloring (every vertex
    v colored v % 32) pulled over both directions of this shard and merged
    twice: as bitwise or (merge_or_words) and as unsigned max
    (merge_all "or")."""
    import torch
    from vectorgraphlibrary_tpu_torch.io import generation
    from vectorgraphlibrary_tpu_torch.parallel import sharded
    from vectorgraphlibrary_tpu_torch.parallel import collectives as C
    from vectorgraphlibrary_tpu_torch.parallel.mesh import make_mesh
    from vectorgraphlibrary_tpu_torch.parallel.shard_build import (
        edge_values_of_shard, import_shard)
    ec = generation.rmat(scale=scale, avg_degree=degree, seed=seed,
                         weighted=True)
    mesh = make_mesh(world, 1, device)
    hosts = []
    g = import_shard(ec, world, rank, device=device, _host_out=hosts)
    w = edge_values_of_shard(ec.weights, ec, world, rank, g, hosts[0])
    labels, flood, hooks = sharded.make_cc_hybrid_sharded(g, mesh)(hub)
    out = dict(
        coloring=sharded.make_coloring_sharded(g, mesh, words=words)(),
        sssp_partial=sharded.make_sssp_sharded_partial(
            g, mesh, w, delta_capacity=256)(source),
        bfs_do=sharded.make_bfs_do_sharded(g, mesh, id_cap=1 << 8,
                                           edge_cap=1 << 12)(source),
        msbfs=sharded.make_msbfs_sharded(g, mesh)(roots),
        cc_hybrid=labels, cc_hybrid_counts=np.asarray([flood, hooks]))
    ids = torch.arange(g.v_pad, dtype=torch.int32, device=device)
    word = torch.where(ids < g.v, torch.bitwise_left_shift(
        torch.ones_like(ids), ids % 32), 0)
    both = (sharded._shard_pull_original(g, word, "or", direction=sharded.G)
            | sharded._shard_pull_original(g, word, "or",
                                           direction=sharded.S))
    out.update(word_or=C.merge_or_words(both, mesh.e_group),
               word_max=C.merge_all(both, "or", mesh.e_group))
    return {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in out.items()}


def sage_inputs(v_pad: int, v: int, fdim: int, classes: int,
                seed: int = 0) -> tuple:
    """(feats f32 [v_pad, fdim], labels int32 [v_pad], mask bool [v_pad]) in
    ORIGINAL order, the padding vertices unmasked."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(v_pad, fdim)).astype(np.float32)
    labels = rng.integers(0, classes, v_pad).astype(np.int32)
    mask = (rng.random(v_pad) < 0.5) & (np.arange(v_pad) < v)
    return feats, labels, mask


def sage_rank(rank: int, world: int, device, params: str, scale: int,
              degree: int, seed: int, fdim: int, classes: int,
              steps: int) -> dict:
    """One rank of test_torch_sharded_sage.py: the sharded GraphSAGE loss
    and its gradients from the parameters in the `params` .npz file, then
    `steps` Adam steps (lr 1e-2) from the same parameters."""
    import torch
    from vectorgraphlibrary_tpu_torch.io import generation
    from vectorgraphlibrary_tpu_torch.models import gnn
    from vectorgraphlibrary_tpu_torch.parallel import sharded
    from vectorgraphlibrary_tpu_torch.parallel.mesh import make_mesh
    from vectorgraphlibrary_tpu_torch.parallel.shard_build import import_shard
    ec = generation.rmat(scale=scale, avg_degree=degree, seed=seed,
                         weighted=True)
    mesh = make_mesh(world, 1, device)
    g = import_shard(ec, world, rank, device=device)
    feats, labels, mask = (torch.from_numpy(a).to(device) for a in
                           sage_inputs(g.v_pad, g.v, fdim, classes))
    with np.load(params) as z:
        arrays = {k: z[k] for k in z.files}
    p = gnn.sage_params_from_numpy(arrays, device=device)
    loss = sharded.make_sage_loss_sharded(g, mesh)(p, feats, labels, mask)
    loss.backward()
    out = {f"grad_{k}": getattr(p, k).grad for k in arrays}
    out["loss"] = loss.detach()
    p = gnn.sage_params_from_numpy(arrays, device=device)
    step = sharded.make_sage_train_step_sharded(
        g, mesh, torch.optim.Adam(p.parameters(), lr=1e-2))
    out["losses"] = torch.stack([step(p, feats, labels, mask)
                                 for _ in range(steps)])
    return {k: v.cpu().numpy() for k, v in out.items()}


def sage_agg_rank(rank: int, world: int, device, scale: int = 12,
                  degree: int = 8, seed: int = 5, fdim: int = 40) -> dict:
    """One rank of the sharded GraphSAGE aggregation on its shard: the
    forward (the merged sums) and the backward of a random cotangent, as
    make_sage_loss_sharded runs them, and the same sums from the plain
    pull_rows over the whole graph's ORIGINAL-order CSR, in f64."""
    import torch
    import torch.distributed as dist
    from vectorgraphlibrary_tpu_torch.io import generation
    from vectorgraphlibrary_tpu_torch.models.gnn import transpose_csr
    from vectorgraphlibrary_tpu_torch.ops.cuda.pull_rows import (
        RowCSR, pull_rows_ref)
    from vectorgraphlibrary_tpu_torch.parallel import sharded
    from vectorgraphlibrary_tpu_torch.parallel.mesh import make_mesh
    from vectorgraphlibrary_tpu_torch.parallel.shard_build import import_shard
    ec = generation.rmat(scale=scale, avg_degree=degree, seed=seed)
    mesh = make_mesh(world, 1, device)
    g = import_shard(ec, world, rank, device=device)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.random((g.v_pad, fdim)).astype(
        np.float32)).to(device).requires_grad_(True)
    cot = torch.from_numpy(rng.random((g.v_pad, fdim)).astype(
        np.float32)).to(device)
    row_ptr, col_idx, _ = sharded._original_csr(g)
    t = RowCSR(*transpose_csr(row_ptr, col_idx, g.v_pad, g.incoming.e))
    out = sharded._ShardNeighbourSum.apply(x, RowCSR(row_ptr, col_idx),
                                           lambda: t, mesh.e_group)
    out.backward(cot)
    # the plain version: every rank's partial in f64, summed
    part = pull_rows_ref(row_ptr, col_idx, x.detach().double())
    part_t = pull_rows_ref(t.row_ptr, t.col_idx, cot.double())
    dist.all_reduce(part, group=mesh.e_group)
    dist.all_reduce(part_t, group=mesh.e_group)
    return {k: v.detach().cpu().numpy() for k, v in dict(
        out=out, grad=x.grad, want_out=part, want_grad=part_t).items()}
