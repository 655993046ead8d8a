"""The three vertex-array exchange policies as torch.distributed collectives
(port of vectorgraphlibrary_tpu/parallel/collectives.py).

Reference (`vgl_compute_api/common/mpi_exchange.hpp`, SURVEY.md §2.4.5):
- EXCHANGE_ALL (:78-187): ring exchange of full arrays + merge op
  → ``merge_all``: one all_reduce (SUM, MIN or MAX) over a group, and
  ``merge_or_words``: the bitwise or of words that differ by rank;
- EXCHANGE_RECENTLY_CHANGED (:14-53): delta compaction + ring + merge
  → ``merge_changed`` (dense, unchanged entries masked to the identity) and
  ``merge_changed_sparse`` (compacted deltas through one all_gather);
- EXCHANGE_PRIVATE_DATA (:193-271): all-gather of owned vertex ranges
  → ``gather_private``.

Each function is called by every rank of `group` (None: the default group)
with tensors of the same shape and type, and returns a new tensor.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

_OPS = {"add": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


def _all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    y = x.clone()
    dist.all_reduce(y, op=op, group=group)
    return y


def _unsigned_max(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise max of x's words as UNSIGNED integers over the group:
    the bitwise-or merge of monotone replicated words (reference :29, :53).
    Neither NCCL nor gloo reduces uint32, and a signed MAX would order
    words with bit 31 set below all others, so the words are widened to
    int64 (x & 0xffffffff for int32), reduced and narrowed back. bool
    reduces as uint8."""
    if x.dtype == torch.bool:
        return _all_reduce(x.to(torch.uint8), dist.ReduceOp.MAX,
                           group).to(torch.bool)
    if x.dtype == torch.uint8:
        return _all_reduce(x, dist.ReduceOp.MAX, group)
    if x.dtype not in (torch.int8, torch.int16, torch.int32):
        raise ValueError(f"'or' merge of {x.dtype}: bool, int8, int16, "
                         "int32 or uint8 words only")
    bits = x.element_size() * 8
    wide = _all_reduce(x.to(torch.int64) & ((1 << bits) - 1),
                       dist.ReduceOp.MAX, group)
    return torch.where(wide >= 1 << (bits - 1), wide - (1 << bits),
                       wide).to(x.dtype)


def merge_all(x: torch.Tensor, merge_op: str, group=None) -> torch.Tensor:
    """EXCHANGE_ALL analog: elementwise merge of every rank's candidate
    array ("add", "min", "max", or "or" as an unsigned max)."""
    if merge_op == "or":
        return _unsigned_max(x, group)
    if merge_op not in _OPS:
        raise ValueError(merge_op)
    if x.dtype == torch.bool:
        return _all_reduce(x.to(torch.uint8), _OPS[merge_op],
                           group).to(torch.bool)
    return _all_reduce(x, _OPS[merge_op], group)


def merge_or_words(x: torch.Tensor, group=None) -> torch.Tensor:
    """Bitwise or of every rank's integer words: one all_gather, then the
    or of the gathered rows (reference sharded.py:304-312). Unlike
    merge_all's unsigned max, right where the ranks' words differ, as a
    SCATTER pull's partial words of one source do."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    out = parts[0]
    for p in parts[1:]:
        out = out | p
    return out


def _identity(merge_op: str, dtype) -> float:
    if dtype.is_floating_point:
        return torch.inf if merge_op == "min" else -torch.inf
    info = torch.iinfo(dtype)
    return info.max if merge_op == "min" else info.min


def merge_changed(x: torch.Tensor, prev: torch.Tensor, merge_op: str,
                  group=None) -> torch.Tensor:
    """EXCHANGE_RECENTLY_CHANGED analog, dense form: only changed entries
    take part; the merge identity stands in for 'not sent' (reference
    merge_op path :146-150)."""
    if merge_op == "add":
        return prev + merge_all(x - prev, "add", group)
    if merge_op in ("min", "max"):
        sent = torch.where(x != prev, x, _identity(merge_op, x.dtype))
        pick = torch.minimum if merge_op == "min" else torch.maximum
        return pick(prev, merge_all(sent, merge_op, group))
    if merge_op == "or":
        # or is idempotent and monotone: unchanged entries equal prev, so
        # the or of every rank's view IS the changed-only merge
        return prev | _unsigned_max(x, group)
    raise ValueError(merge_op)


def _compact_delta(x: torch.Tensor, prev: torch.Tensor, capacity: int):
    """This rank's changed (index, value) pairs in a static [capacity]
    buffer (the reference's prepare_exchange_data, mpi_exchange.hpp:14-53).
    Returns (idx, val, count); unused entries hold index n, and entries past
    capacity are dropped: callers guard with the group's overflow test."""
    n = x.shape[0]
    changed = x != prev
    pos = torch.cumsum(changed.to(torch.int64), 0) - 1
    slot = torch.where(changed, pos.clamp(max=capacity - 1), capacity)
    idx = torch.full((capacity + 1,), n, dtype=torch.int32, device=x.device)
    idx[slot] = torch.arange(n, dtype=torch.int32, device=x.device)
    idx = idx[:capacity]
    val = x[idx.clamp(max=n - 1).long()]
    return idx, val, changed.sum(dtype=torch.int64)


def delta_capacity_policy(n: int, n_devices: int,
                          requested: int | None = None) -> int:
    """Clamp a merge_changed_sparse capacity so the sparse branch can never
    move more bytes than the dense merge it is meant to beat.

    Bytes per rank: sparse ≈ 8·D·cap in (an all_gather of 4-byte indices
    and 4-byte values from every rank) + 8·cap out; a dense ring
    all-reduce ≈ 8·n. Equal bytes at cap* = n/D; the policy keeps 4x
    headroom: cap = min(requested or n/64, n/(4·D)), floor 64."""
    cross = max(64, n // (4 * max(n_devices, 1)))
    if requested is None:
        requested = max(256, n // 64)
    return max(64, min(requested, cross))


def merge_changed_sparse(x: torch.Tensor, prev: torch.Tensor, merge_op: str,
                         capacity: int, group=None) -> torch.Tensor:
    """EXCHANGE_RECENTLY_CHANGED, compacted form: each rank compacts its
    changed (index, value) deltas into a [capacity] buffer, the buffers
    ride one all_gather, and every rank merges the gathered deltas into
    prev. When ANY rank has more than `capacity` changes (one MAX
    all-reduce of the counts, which every rank then reads the same), the
    dense merge_changed runs instead: the reference's lax.cond between
    the two branches. "or" takes bool (or {0, 1}) values, as there."""
    if merge_op not in ("min", "max", "add", "or"):
        raise ValueError(merge_op)
    n = x.shape[0]
    worst = merge_all((x != prev).sum(dtype=torch.int64).reshape(1), "max",
                      group)
    if int(worst) > capacity:
        return merge_changed(x, prev, merge_op, group)
    idx, val, _ = _compact_delta(x, prev, capacity)
    size = dist.get_world_size(group)
    gi = [torch.empty_like(idx) for _ in range(size)]
    gv = [torch.empty_like(val) for _ in range(size)]
    dist.all_gather(gi, idx, group=group)
    dist.all_gather(gv, val, group=group)
    gi, gv = torch.cat(gi).long(), torch.cat(gv)
    real = gi < n
    # one slot past the end takes the unused entries
    out = torch.cat([prev, prev[:1]])
    if merge_op == "add":
        delta = gv - prev[gi.clamp(max=n - 1)]
        return out.index_add_(0, gi, torch.where(real, delta, 0))[:n]
    reduce = "amin" if merge_op == "min" else "amax"
    if out.dtype == torch.bool:
        return out.to(torch.uint8).scatter_reduce_(
            0, gi, gv.to(torch.uint8), reduce)[:n].to(torch.bool)
    return out.scatter_reduce_(0, gi, gv, reduce)[:n]


def gather_private(x_local: torch.Tensor, group=None) -> torch.Tensor:
    """EXCHANGE_PRIVATE_DATA analog: every rank's owned contiguous vertex
    range, joined in group-rank order."""
    parts = [torch.empty_like(x_local)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x_local.contiguous(), group=group)
    return torch.cat(parts)


def scatter_to_owner(values: torch.Tensor, global_idx: torch.Tensor,
                     v_local: int, group=None, combine: str = "add",
                     init: torch.Tensor | None = None) -> torch.Tensor:
    """Scatter edge-parallel messages into this rank's owned vertex range
    [r * v_local, (r + 1) * v_local), r its rank in `group`; indices out of
    the range are dropped (they belong to other ranks)."""
    rank = dist.get_rank(group)
    local = global_idx.to(torch.int64) - rank * v_local
    local = torch.where((local >= 0) & (local < v_local), local, v_local)
    out = (torch.zeros(v_local, dtype=values.dtype, device=values.device)
           if init is None else init)
    out = torch.cat([out, out.new_zeros(1)])
    if combine == "add":
        return out.index_add_(0, local, values)[:v_local]
    if combine in ("min", "max"):
        return out.scatter_reduce_(0, local, values,
                                   "amin" if combine == "min" else "amax"
                                   )[:v_local]
    raise ValueError(combine)
