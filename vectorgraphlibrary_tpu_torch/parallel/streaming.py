"""Host streaming for sharded graphs larger than the card's memory (port of
vectorgraphlibrary_tpu/parallel/streaming.py).

The scan runners (parallel/sharded.*_scan) bound the working set to one
shard's pull, but keep every shard on the card. Here the shards live in host
memory and are copied to the card one at a time per sweep, so the card holds
one shard (at most two) and the [v_pad] vertex state. The shards are kept
slim (shard_build.slim_value_pull: each direction's CSR, no advance route and
no tiles), which is all the port's pull reads, with each direction's pull
plan made once at load; on a card they are pinned, so each copy runs at the
link's rate. Stored weights (persistence.load_sharded_weights, route-slot
order) are laid out in CSR slot order once, at load.

Every algorithm runs both directions of a sweep while a shard is on the
card where the sweep needs both (the undirected or-flood and hook of CC),
so a sweep copies each shard once. After each shard's step the host waits
for the card (the backpressure of the reference's _sweep,
streaming.py:126-141): without it the host would queue every shard's copy,
and the copies' memory would coexist. A failed pin or allocation raises;
nothing falls back to the CPU or to a resident graph.

The algorithms are parallel/sharded's loop bodies (_pagerank, _hits,
_msbfs, _cc_hybrid, _sssp) over a pull that is one sweep. The loops read
one convergence value per sweep on the host, as the reference's do. `StreamedShardedGraph` counts the shards resident on the
card (`resident`, `peak_resident`), the bytes copied (`h2d_bytes`) and each
sweep's wall time (`sweep_s`).
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..config import TraversalDirection
from ..graph.device import VGLGraph
from ..graph.edges import DirectedEdgeValues
from ..ops import monoid as M
from ..ops.advance import pull_plan
from ..ops.cuda.pull_reduce import Plan
from .sharded import (_cc_hybrid, _hits, _msbfs, _pagerank,
                      _shard_pull_original, _sssp)

S_, G = TraversalDirection.SCATTER, TraversalDirection.GATHER


@dataclasses.dataclass
class StreamedShardedGraph:
    """Host-resident slim shards and their metadata (the streaming twin of
    ShardedTileGraph). weights: each shard's incoming edge weights in CSR
    slot order, f32 [e_pad], or None; device: where the sweeps run."""

    shards: List[VGLGraph]
    weights: Optional[List[torch.Tensor]]
    v: int
    v_pad: int
    e: int
    n_shards: int
    edges_per_shard: List[int]
    device: torch.device
    resident: int = 0
    peak_resident: int = 0
    h2d_bytes: int = 0
    sweep_s: List[float] = dataclasses.field(default_factory=list)


def _map_tensors(obj, fn):
    """obj with fn applied to every tensor in its dataclasses and tuples."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _map_tensors(getattr(obj, f.name), fn)
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple):
        return tuple(_map_tensors(x, fn) for x in obj)
    return obj


def _host_shard(g: VGLGraph, pin: bool) -> VGLGraph:
    """g (slim) without its slot map, with its pull plans made, pinned for
    the card when `pin`. The sweeps read the weights in CSR slot order and
    never the slot map (4 B an edge of every copy)."""
    g = dataclasses.replace(g, in_route_slots=None)
    if pin:
        g = _map_tensors(g, lambda t: t.pin_memory())
    for dg in (g.outgoing, g.incoming):
        pull_plan(dg)
    return g


def load_streamed(path_prefix: str, weights: bool = False,
                  device="cuda") -> StreamedShardedGraph:
    """A sharded graph saved by either package (persistence.
    save_sharded_graph; full or slim shards of the port, full shards of
    the JAX package) into host memory for streaming to `device`; with
    weights=True also its stored weights (`{prefix}.weights{s}.npy`),
    laid out in CSR slot order here. On a card the host copies are
    pinned."""
    from ..graph import persistence
    device = torch.device(device)
    pin = device.type == "cuda"
    with open(f"{path_prefix}.meta.json") as f:
        meta = json.load(f)
    shards = [persistence.load_graph_from_binary_file(
        f"{path_prefix}.shard{s}.npz", device="cpu", slim=True)
        for s in range(meta["n_shards"])]
    ws = None
    if weights:
        slot_w = persistence.load_sharded_weights(path_prefix,
                                                  meta["n_shards"], "cpu")
        ws = [slot_w[s][g.in_route_slots.long()] for s, g in
              enumerate(shards)]
        if pin:
            ws = [w.pin_memory() for w in ws]
    return StreamedShardedGraph(
        shards=[_host_shard(g, pin) for g in shards], weights=ws,
        v=meta["v"], v_pad=meta["v_pad"], e=meta["e"],
        n_shards=meta["n_shards"],
        edges_per_shard=list(meta["edges_per_shard"]), device=device)


def _put(ssg: StreamedShardedGraph, s: int) -> VGLGraph:
    """Shard s on the device, with its pull plans."""
    nbytes = [0]

    def copy(t):
        nbytes[0] += t.numel() * t.element_size()
        return t.to(ssg.device, non_blocking=True)
    host = ssg.shards[s]
    g = _map_tensors(host, copy)
    for h, d in ((host.outgoing, g.outgoing), (host.incoming, g.incoming)):
        plan = pull_plan(h)
        d.derived("pull_plan", lambda: Plan(
            d.row_ptr, copy(plan.tiles), copy(plan.fix), plan.n_tiles,
            plan.n_fix))
    ssg.h2d_bytes += nbytes[0]
    ssg.resident += 1
    ssg.peak_resident = max(ssg.peak_resident, ssg.resident)
    return g


def _wait(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _sweep(ssg: StreamedShardedGraph, step: Callable, label: str,
           progress=None) -> None:
    """step(shard on the device, s) for every shard in turn: one copy, one
    step, the host waits for the card, the shard is freed."""
    t0 = time.perf_counter()
    for s in range(ssg.n_shards):
        g = _put(ssg, s)
        step(g, s)
        _wait(ssg.device)
        del g
        ssg.resident -= 1
    ssg.sweep_s.append(time.perf_counter() - t0)
    if progress:
        progress(f"{label} sweep {len(ssg.sweep_s)}: {ssg.sweep_s[-1]:.1f}s")


def _stream_pull(ssg: StreamedShardedGraph, label: str, progress=None,
                 weighted: bool = False) -> Callable:
    """The loop bodies' pull (parallel/sharded._pagerank and its kin) over
    the streamed shards: pull(x_o, combine, direction=G, **kw) is one
    sweep, each shard's pull combined into one accumulator. weighted:
    each shard's stored weights are copied with it (GATHER pulls only, as
    sharded_pull_scan's weight_fn). progress(text) after every sweep."""
    def pull(x_o, combine, direction=G, **kw):
        if weighted and direction != G:
            raise ValueError("stored weights are incoming: GATHER pulls only")
        mon = M.get(combine)
        acc = [None]

        def step(g, s):
            ev = _put_weights(ssg, s) if weighted else None
            out = _shard_pull_original(g, x_o, combine, direction=direction,
                                       edge_values=ev, **kw)
            acc[0] = out if acc[0] is None else mon.combine(acc[0], out)
        _sweep(ssg, step, label, progress)
        return acc[0]
    return pull


def _stream_und(ssg: StreamedShardedGraph, label: str, progress=None
                ) -> Callable:
    """und(x_o, combine): x_o pulled over both directions while each shard
    is on the card, all combined (one sweep)."""
    def und(x_o, combine):
        mon = M.get(combine)
        acc = [None]

        def step(g, s):
            out = mon.combine(
                _shard_pull_original(g, x_o, combine, direction=G),
                _shard_pull_original(g, x_o, combine, direction=S_))
            acc[0] = out if acc[0] is None else mon.combine(acc[0], out)
        _sweep(ssg, step, label, progress)
        return acc[0]
    return und


def _put_weights(ssg: StreamedShardedGraph, s: int) -> DirectedEdgeValues:
    if ssg.weights is None:
        raise ValueError("the graph was loaded without weights "
                         "(load_streamed(..., weights=True))")
    w = ssg.weights[s]
    ssg.h2d_bytes += w.numel() * w.element_size()
    return DirectedEdgeValues(flat=w.to(ssg.device, non_blocking=True))


def _padded(a, v_pad: int, device, dtype) -> torch.Tensor:
    a = torch.as_tensor(np.asarray(a)).to(dtype)
    if a.shape[0] < v_pad:
        a = torch.cat([a, a.new_zeros(v_pad - a.shape[0])])
    return a.to(device)


def pagerank_streamed(ssg: StreamedShardedGraph, rev, dmask,
                      iterations: int = 10, damping: float = 0.85,
                      progress=None) -> torch.Tensor:
    """Streamed pull PageRank; rev, dmask as sharded.pr_consts gives them
    (padded to v_pad here). -> ranks [v_pad] ORIGINAL."""
    dev = ssg.device
    consts = (_padded(rev, ssg.v_pad, dev, torch.float32),
              _padded(dmask, ssg.v_pad, dev, torch.bool))
    return _pagerank(_stream_pull(ssg, "pr", progress), consts, ssg.v,
                     ssg.v_pad, dev, damping, iterations)


def hits_streamed(ssg: StreamedShardedGraph, iterations: int = 5,
                  progress=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Streamed HITS: two sweeps per iteration (the hub pull needs the new
    authorities). -> (auth, hub) [v_pad] ORIGINAL."""
    return _hits(_stream_pull(ssg, "hits", progress), ssg.v, ssg.v_pad,
                 ssg.device, iterations)


def msbfs_streamed(ssg: StreamedShardedGraph, roots, max_levels: int = 126,
                   progress=None) -> tuple[torch.Tensor, int]:
    """Bit-parallel 32-root MS-BFS, streamed: one "or" sweep per level, at
    most max_levels (capped at 126, so that the levels fit int8). ->
    (levels int8 [32, v_pad] ORIGINAL, the last level swept)."""
    return _msbfs(_stream_pull(ssg, "msbfs", progress), ssg.v, ssg.v_pad,
                  ssg.device, roots, min(max_levels, 126))


def cc_hybrid_streamed(ssg: StreamedShardedGraph, hub: int,
                       max_flood_levels: int = 1000,
                       max_iterations: int = 1000, progress=None
                       ) -> tuple[torch.Tensor, int, int]:
    """Streamed flood-hybrid CC (cc_hybrid_sharded_scan's twin, with the
    non-closure guard): each flood level and each hook one sweep of both
    directions. -> (labels [v_pad] ORIGINAL, flood levels, hooks)."""
    return _cc_hybrid(_stream_und(ssg, "cc", progress), ssg.v, ssg.v_pad,
                      ssg.device, hub, max_flood_levels, max_iterations)


def sssp_streamed(ssg: StreamedShardedGraph, source: int,
                  max_iterations: int = 10_000, partial: bool = False,
                  progress=None) -> tuple[torch.Tensor, int]:
    """Streamed Bellman-Ford on the stored weights (load_streamed(...,
    weights=True)), each shard's copied with it. All-active by default: a
    sweep copies every shard anyway, so fewer sweeps beat partial-active's
    smaller pulls. -> (dist [v_pad] ORIGINAL, sweeps)."""
    if ssg.weights is None:
        raise ValueError("sssp_streamed: the graph was loaded without "
                         "weights (load_streamed(..., weights=True))")
    return _sssp(_stream_pull(ssg, "sssp", progress, weighted=True), ssg.v,
                 ssg.v_pad, ssg.device, source, partial, max_iterations)
