"""Per-primitive profiling pass (port of
vectorgraphlibrary_tpu/runtime/prim_profile.py).

The reference accrues time, bytes and edges inside every abstraction call
(`vgl_runtime/helpers/performance_stats/performance_stats.hpp:259-316,
471-479`, `advance_worker.hpp:347-360`). As in the JAX package, each app
instead runs one measured pass over the framework's primitives on its own
graph after the measured rounds, with a bytes model per primitive, so that
print_timers_stats shows the reference's table (ms, GB/s, % of the
roofline, MTEPS per primitive) from timings on the device. Five rows, with
the JAX package's names, shapes and edges-visited counts:

- "reorder (vertex route)": the GATHER → SCATTER vertex route of an f32
  [v_pad] (one route_gather launch);
- "advance (pull add)": advance_pull_value add over the incoming CSR (one
  pull_reduce launch);
- "advance (pull min+w)" with weights, the min of x + w over the same CSR,
  else "advance (pull min)" (one pull_reduce launch);
- "advance (push sparse)": advance_push_sparse of `s["d"]` min into an f32
  [v_pad] from the first 1,024 ids, edge capacity min(2^17, e) (two
  scatter_combine launches: the in-place int32 owner mark, the f32 min);
- "generate_new_frontier": compact_ids of a mask of every seventh vertex
  into 2^15 ids (one torch.sort).

Timing: each primitive runs once untimed, then `reps` times by DeviceTimer
(CUDA events on the current stream, host dispatch included, as a caller
sees it); the best has `_dispatch_baseline()` subtracted (the DeviceTimer
time of one tiny torch op on the same device: the fixed host cost of one
dispatch) and is floored at 5 % of itself, as in the JAX package. On the
card the untimed call runs behind a spin kernel that holds the stream
while the host enqueues it, so its events time the device's work alone;
the result is never below that device time (nor above the best time).
Without that floor a one-launch primitive whose host path is cheaper than
a torch op's would read faster than the card can move its bytes.

Bytes models (the port's own; each input read once, each output written
once; 4 B per int32 and f32; v = v_pad, e = |E|, cap = 1,024 frontier ids,
m = the edges those ids expand to, at most the edge capacity; mask bytes
1 B per vertex):

- reorder: 12·v (the gather index, x, the result);
- pull add: 4·(v + 1) + 4·e + 4·v + 4·v (row_ptr, col_idx, x, the result);
  pull min+w adds 4·e (the weights); pull min as pull add;
- push sparse: 17·cap (ids, valid flags, and per id its row start, degree
  and value) + 4·m (the expanded edges' destinations) + 8·v (the target
  read, the result written);
- generate_new_frontier: v (the mask) + 5·2^15 (the ids, the valid flags).
"""
from __future__ import annotations

import torch

from ..config import TraversalDirection
from ..graph.device import VGLGraph
from ..graph.frontier import Frontier, compact_ids
from ..ops.advance import advance_pull_value, advance_push_sparse
from ..ops.route import apply_route
from .perf_stats import PerformanceStats, performance_stats
from .timer import DeviceTimer

G, S = TraversalDirection.GATHER, TraversalDirection.SCATTER

FRONTIER_CAP = 1024
EDGE_CAP = 1 << 17
COMPACT_CAP = 1 << 15
# GPU clock cycles of the spin before an untimed call on the card: about a
# millisecond at the H100's 1.98 GHz, more than the host takes to enqueue
# any of the primitives
_SPIN_CYCLES = 2_000_000

_baseline_cache: dict = {}


def _dispatch_baseline(device: torch.device) -> float:
    """Seconds of one tiny torch op on `device` by DeviceTimer, best of 5,
    measured once per device."""
    key = str(device)
    if key not in _baseline_cache:
        x = torch.zeros((8, 128), dtype=torch.float32, device=device)
        x + 1
        best = float("inf")
        for _ in range(5):
            t = DeviceTimer(device).start()
            y = x + 1
            best = min(best, t.stop(y))
        _baseline_cache[key] = best
    return _baseline_cache[key]


def _timeit(fn, device: torch.device, reps: int) -> float:
    floor = 0.0
    if device.type == "cuda":
        torch.cuda._sleep(_SPIN_CYCLES)
        t = DeviceTimer(device).start()
        fn()
        floor = t.stop()
    else:
        fn()
    best = float("inf")
    for _ in range(reps):
        t = DeviceTimer(device).start()
        out = fn()
        best = min(best, t.stop(out))
    return max(best - _dispatch_baseline(device), best * 0.05,
               min(floor, best))


def profile_graph_primitives(graph: VGLGraph, weights=None,
                             stats: PerformanceStats = performance_stats,
                             reps: int = 3) -> None:
    """Measure the core primitives on `graph` (on its device) and accrue
    them into `stats`, so that print_timers_stats shows the reference's
    per-primitive breakdown. `weights` is the graph's EdgeArray or None.
    Each primitive runs reps + 1 times."""
    dev = graph.device
    v_pad, e = graph.v_pad, graph.e
    x = torch.arange(v_pad, dtype=torch.float32, device=dev) / v_pad

    dt = _timeit(lambda: apply_route(graph.vertex_route_s_from_g, x), dev,
                 reps)
    stats.update("reorder (vertex route)", dt, 12 * v_pad, v_pad)

    pull_bytes = 4 * (v_pad + 1) + 4 * e + 8 * v_pad
    dt = _timeit(lambda: advance_pull_value(graph, x, "add", direction=G),
                 dev, reps)
    stats.update("advance (pull add)", dt, pull_bytes, e)

    if weights is not None:
        dt = _timeit(lambda: advance_pull_value(
            graph, x, "min", edge_values=weights.incoming, weight_op="add",
            direction=G), dev, reps)
        stats.update("advance (pull min+w)", dt, pull_bytes + 4 * e, e)
    else:
        dt = _timeit(lambda: advance_pull_value(graph, x, "min",
                                                direction=G), dev, reps)
        stats.update("advance (pull min)", dt, pull_bytes, e)

    cap = min(FRONTIER_CAP, v_pad)
    ecap = min(EDGE_CAP, max(e, 8))
    ids = torch.arange(cap, dtype=torch.int32, device=dev)
    valid = ids < min(cap, graph.v)
    out0 = torch.full((v_pad,), float("inf"), dtype=torch.float32,
                      device=dev)
    m = min(int(graph.outgoing.degrees[:min(cap, graph.v)].sum()), ecap)
    dt = _timeit(lambda: advance_push_sparse(
        graph, ids, valid, ecap, {"d": x}, lambda s, d, w: s["d"], "min",
        out0, direction=S), dev, reps)
    stats.update("advance (push sparse)", dt, 17 * cap + 4 * m + 8 * v_pad,
                 ecap)

    mask = torch.arange(v_pad, device=dev) % 7 == 0
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    dt = _timeit(lambda: compact_ids(Frontier(
        mask=mask, size=torch.sum(mask, dtype=torch.int32),
        neighbours_count=zero, direction=S), COMPACT_CAP), dev, reps)
    stats.update("generate_new_frontier", dt, v_pad + 5 * COMPACT_CAP,
                 v_pad)
