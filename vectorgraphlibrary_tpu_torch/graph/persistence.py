"""Binary persistence for preprocessed graphs (port of
vectorgraphlibrary_tpu/graph/persistence.py: one graph per .npz file, and a
sharded graph as one file per shard beside a meta file).

The expensive import pipeline (degree sort, tiling, routes) runs once, then
the whole device graph round-trips through one .npz file in the JAX
package's format, so one preprocessed file serves both packages (reference
save/load_main_content_to_binary_file, vect_csr_graph.h:90-92):

- the same keys, shapes, dtypes and `meta` vectors. A bucket narrower than
  128 is stored lane-major as (rows_pad * width // 128, 128), the JAX
  package's device layout; the port holds it as (rows_pad, width), the same
  slot order.
- a route is stored as a Beneš network, not a permutation: the stage arrays
  (`in_masks`/`out_masks` bit planes, `lane_idx`, `lane_inv`), the fused
  word masks (`mid_words`/`big_words`, which also carry the advance route's
  finish flags), or both. Saving runs the Beneš router (native.py) on each
  plan's permutation and writes both, as a graph built on a CPU host does.
  Loading executes the stored network on the device (ops/route.
  apply_route_stages: two lane-shuffle launches per plan) to recover the
  port's gather indices; a file saved on a TPU carries only the words, which
  are unpacked first.
- a slim shard of the JAX package keeps the advance route and drops each
  direction's CSR; the loader rebuilds the CSRs from the route's flags and
  permutation and the tiles' metadata (route_build.csrs_from_route).
  save_jax_slim_sharded writes such files from full ones.
- per-slot CSR edge indices (`eidx`, in files of weighted graphs) are not
  read: they map tile slots to CSR slots, to lay out the JAX package's tile
  copies of edge values, and the port keeps edge values only in CSR slot
  order (graph/edges.EdgeArray.flat), where that mapping has no use.
"""
from __future__ import annotations

import json
import shutil

import numpy as np
import torch

from ..config import GraphFormat
from ..ops.route import (RoutePlan, benes_plan_from_packed, inverse_lanes,
                         pack_masks, plan_from_benes)
from ..ops.route_words import (build_word_masks, split_levels,
                               unpack_word_masks, word_flags)
from .device import DeviceDirectedGraph, TileBucket, VGLGraph, huge_tile
from .route_build import csrs_from_route, in_route_slots

# the values of the "format" key that the port builds: a graph, a shard
FORMATS = (GraphFormat.TILE_CSR.value, GraphFormat.SHARDED_CSR.value)
_VROUTES = (("vroute", "vertex_route_s_from_g"),
            ("vroute_so", "vertex_route_s_from_o"),
            ("vroute_go", "vertex_route_g_from_o"))
_STAGE_KEYS = ("in_masks", "out_masks", "lane_idx")
# the fused word masks exist from 8 rows of 128 slots on (reference
# route.py:92)
_MIN_WORDS_N = 1024


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _pack_directed(prefix: str, dg: DeviceDirectedGraph, out: dict,
                   sharded: bool) -> None:
    """A shard's meta holds e_pad as its edge count, as the JAX package's
    does (its shards stack only with one count); the CSR's own count is
    row_ptr[-1]. A slim shard's absent arrays (the renumber maps and the
    tiles' adjacency) have no key, as in the JAX package's slim files."""
    def put(key, t):
        if t is not None:
            out[key] = _np(t)
    put(f"{prefix}.row_ptr", dg.row_ptr)
    put(f"{prefix}.col_idx", dg.col_idx)
    put(f"{prefix}.degrees", dg.degrees)
    put(f"{prefix}.sorted_to_orig", dg.sorted_to_orig)
    put(f"{prefix}.orig_to_sorted", dg.orig_to_sorted)
    out[f"{prefix}.meta"] = np.asarray([dg.v, dg.v_pad,
                                        dg.e_pad if sharded else dg.e,
                                        dg.e_pad,
                                        len(dg.buckets),
                                        1 if dg.huge is not None else 0])
    for i, b in enumerate(dg.buckets):
        if b.adj is not None:
            adj = _np(b.adj)
            if b.width < 128:
                adj = adj.reshape(b.rows_pad * b.width // 128, 128)
            out[f"{prefix}.b{i}.adj"] = adj
        out[f"{prefix}.b{i}.meta"] = np.asarray(
            [b.width, b.row_start, b.rows, b.rows_pad])
    if dg.huge is not None:
        h = dg.huge
        put(f"{prefix}.huge.adj", h.adj)
        out[f"{prefix}.huge.seg_ids"] = _np(h.seg_ids)
        out[f"{prefix}.huge.meta"] = np.asarray(
            [h.chunk_w, h.n_rows, h.n_chunks, h.n_chunks_pad])


def _i32(z, key: str, device) -> torch.Tensor:
    a = z[key]
    if a.dtype != np.int32:
        raise ValueError(f"{key}: {a.dtype}, expected int32")
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _unpack_tiles(prefix: str, z, device, slim: bool) -> tuple:
    """A direction's (buckets, huge) on `device`; slim: without the tiles'
    adjacency, which a slim shard's file does not hold."""
    _, _, _, _, nb, has_huge = z[f"{prefix}.meta"].tolist()

    def opt(key):
        return None if slim else _i32(z, key, device)
    buckets = []
    for i in range(nb):
        w, rs, r, rp = z[f"{prefix}.b{i}.meta"].tolist()
        adj = opt(f"{prefix}.b{i}.adj")
        if adj is not None:
            if adj.numel() != rp * w:
                raise ValueError(f"{prefix}.b{i}.adj: {tuple(adj.shape)} for "
                                 f"{rp} rows of width {w}")
            adj = adj.reshape(rp, w)
        buckets.append(TileBucket(adj=adj, width=w, row_start=rs, rows=r,
                                  rows_pad=rp))
    huge = None
    if has_huge:
        cw, nr, nc, ncp = z[f"{prefix}.huge.meta"].tolist()
        huge = huge_tile(opt(f"{prefix}.huge.adj"),
                         z[f"{prefix}.huge.seg_ids"], cw, nr, nc, ncp, device)
    return tuple(buckets), huge


def _unpack_directed(prefix: str, z, device, slim: bool, tiles=None,
                     csr=None) -> DeviceDirectedGraph:
    """slim: the direction gets no tiles' adjacency nor renumber maps (a
    slim shard's file holds none) and its col_idx ends at the CSR's
    edges, as slim_value_pull leaves it. csr: (row_ptr, col_idx, degrees)
    rebuilt from the advance route (route_build.csrs_from_route), for a
    file that holds none; tiles: its (buckets, huge) where already read."""
    v, v_pad, e, e_pad, _, _ = z[f"{prefix}.meta"].tolist()
    if csr is None:
        e_csr = int(z[f"{prefix}.row_ptr"][-1])
        col_idx = _i32(z, f"{prefix}.col_idx", device)
        csr = (_i32(z, f"{prefix}.row_ptr", device),
               col_idx[:e_csr].clone() if slim else col_idx,
               _i32(z, f"{prefix}.degrees", device))
    else:
        e_csr = csr[1].numel()
    # the port's e is the CSR's edge count (a shard's meta holds e_pad)
    if e not in (e_csr, e_pad):
        raise ValueError(f"{prefix}.meta: {e} edges; its CSR holds {e_csr}")
    buckets, huge = tiles or _unpack_tiles(prefix, z, device, slim)

    def opt(key):
        return None if slim else _i32(z, key, device)
    return DeviceDirectedGraph(
        row_ptr=csr[0], col_idx=csr[1], degrees=csr[2],
        sorted_to_orig=opt(f"{prefix}.sorted_to_orig"),
        orig_to_sorted=opt(f"{prefix}.orig_to_sorted"),
        buckets=buckets, huge=huge, v=v, v_pad=v_pad, e=e_csr, e_pad=e_pad)


def _pack_route(prefix: str, plan: RoutePlan, out: dict) -> None:
    """Both encodings of the plan's Beneš network (reference _pack_route and
    make_route_plan on a CPU host): the router runs on plan.fwd_idx."""
    from .. import native
    n = plan.n
    in_m, out_m, lane = native.benes_route(_np(plan.fwd_idx))
    lane2d = lane.reshape(-1, 128)
    out[f"{prefix}.in_masks"] = pack_masks(in_m)
    out[f"{prefix}.out_masks"] = pack_masks(out_m)
    out[f"{prefix}.lane_idx"] = lane2d
    out[f"{prefix}.lane_inv"] = inverse_lanes(lane2d)
    kb = kq = 0
    has_flags = False
    if n >= _MIN_WORDS_N:
        kb, kq = split_levels(n)
        flags = [None if f is None else _np(f)
                 for f in (plan.flags_fwd, plan.flags_inv)]
        mid, big = build_word_masks(in_m, out_m, n, lane_fwd=lane2d,
                                    flags_fwd=flags[0], flags_inv=flags[1])
        out[f"{prefix}.mid_words"] = mid
        if big is not None:
            out[f"{prefix}.big_words"] = big
        has_flags = flags[0] is not None or flags[1] is not None
    out[f"{prefix}.meta"] = np.asarray([n, in_m.shape[0], kb, kq,
                                        1 if has_flags else 0])


def _unpack_route(prefix: str, z, device, needs_flags: bool) -> RoutePlan:
    """The stored network, executed on `device` into a gather-index plan.
    Takes the stage arrays when the file has them, else the word masks; the
    finish flags come from the words."""
    meta = z[f"{prefix}.meta"].tolist()
    if len(meta) == 4:               # the older layout, without has_flags
        meta = meta + [0]
    n, levels, _, _, has_flags = meta
    mid = z[f"{prefix}.mid_words"] if f"{prefix}.mid_words" in z else None
    big = z[f"{prefix}.big_words"] if f"{prefix}.big_words" in z else None
    lane_inv = z[f"{prefix}.lane_inv"]
    flags_fwd = flags_inv = None
    if all(f"{prefix}.{k}" in z for k in _STAGE_KEYS):
        bplan = benes_plan_from_packed(
            z[f"{prefix}.in_masks"], z[f"{prefix}.out_masks"],
            z[f"{prefix}.lane_idx"], lane_inv, device)
        if has_flags:
            flags_fwd, flags_inv = word_flags(mid, big, n)
    elif mid is not None:
        in_m, out_m, lane2d, ff, fi = unpack_word_masks(mid, big, n)
        bplan = benes_plan_from_packed(pack_masks(in_m), pack_masks(out_m),
                                       lane2d, lane_inv, device)
        if has_flags:
            flags_fwd, flags_inv = ff, fi
    else:
        raise ValueError(f"route {prefix!r} holds neither stage masks nor "
                         "word masks")
    if bplan.n != n or bplan.levels != levels:
        raise ValueError(f"route {prefix!r}: meta says n = {n}, levels = "
                         f"{levels}; its arrays hold n = {bplan.n}")
    if needs_flags and not has_flags:
        raise ValueError(
            f"route {prefix!r} was saved without the finish flags the "
            "advance needs (a route of fewer than 1024 slots has no word "
            "masks to hold them)")
    return plan_from_benes(bplan, flags_fwd, flags_inv, device)


def save_graph_to_binary_file(graph: VGLGraph, path: str,
                              compressed: bool = True) -> None:
    """Write `graph` (a TILE_CSR graph or a shard) to `path` (.npz) in the
    JAX package's format. Raises ValueError, before anything is written,
    for another format, which the loader would refuse, and for a graph
    imported with build_route=False: the format holds the advance route.
    A slim shard (parallel/shard_build.slim_value_pull) has no advance
    route, tiles' adjacency or renumber maps, and its file none either;
    only the port loads it (the JAX package's pull needs the route)."""
    if graph.graph_format.value not in FORMATS:
        raise ValueError(f"save_graph_to_binary_file: a graph of format "
                         f"{graph.graph_format.value!r}; the port writes "
                         f"{FORMATS}")
    if graph.advance_route is None and not graph.slim:
        raise ValueError("save_graph_to_binary_file: the graph has no "
                         "advance route (imported with build_route=False); "
                         "import it with build_route=True to save it")
    out = {}
    sharded = graph.graph_format == GraphFormat.SHARDED_CSR
    _pack_directed("out", graph.outgoing, out, sharded)
    _pack_directed("in", graph.incoming, out, sharded)
    out["meta"] = np.asarray([graph.v, graph.v_pad, graph.e, graph.out_slots,
                              graph.in_slots])
    out["format"] = np.asarray([graph.graph_format.value], dtype="U16")
    if not graph.slim:
        _pack_route("route", graph.advance_route, out)
    for prefix, attr in _VROUTES:
        _pack_route(prefix, getattr(graph, attr), out)
    (np.savez_compressed if compressed else np.savez)(path, **out)


# what the port's pull reads of each direction; the JAX package's slim
# shard files lack them (vectorgraphlibrary_tpu/parallel/shard_build.py
# :159-176 strips the CSR and keeps the advance route), and the loader
# rebuilds them from the route
_CSR_KEYS = ("row_ptr", "col_idx", "degrees")


def load_graph_from_binary_file(path: str, device="cuda",
                                slim: bool = False) -> VGLGraph:
    """Read a graph (or one shard of a sharded graph) saved by either
    package onto `device`. device="cpu" keeps every tensor in host memory:
    the counterpart of the reference's as_numpy=True (the streaming loader,
    parallel/streaming.py, reads shards so). A file without the advance
    route is a slim shard of the port's; slim=True reads a shard's file
    as slim_value_pull would leave it, without executing its advance
    route's network. A JAX package's slim shard holds the advance route
    and no CSR: the loader executes the route's network on `device` (two
    lane_shuffle launches on a card, the plain version on the CPU) and
    rebuilds both CSRs from it (route_build.csrs_from_route), then returns
    the port's slim shard, without the route. A shard gets its
    in_route_slots from its incoming CSR and tiles' metadata."""
    device = torch.device(device)
    with np.load(path) as z:
        fmt = str(z["format"][0])
        if fmt not in FORMATS:
            raise ValueError(f"{path}: graph format {fmt!r}; the port reads "
                             f"{FORMATS} graphs only")
        missing = [f"{d}.{k}" for d in ("out", "in") for k in _CSR_KEYS
                   if f"{d}.{k}" not in z]
        if missing and (len(missing) < 2 * len(_CSR_KEYS)
                        or "route.meta" not in z):
            raise ValueError(
                f"{path}: no {', '.join(missing)}: neither a full file nor "
                "a slim shard that keeps its advance route (written by "
                "neither package's save)")
        v, v_pad, e, out_slots, in_slots = z["meta"].tolist()
        for prefix, _ in _VROUTES:
            if f"{prefix}.meta" not in z:
                raise ValueError(f"{path}: no route {prefix!r}")
        vroutes = {attr: _unpack_route(prefix, z, device, needs_flags=False)
                   for prefix, attr in _VROUTES}
        graph_format = GraphFormat.parse(fmt)
        sharded = graph_format == GraphFormat.SHARDED_CSR
        if missing:
            slim = True
            tiles = {d: _unpack_tiles(d, z, device, slim=True)
                     for d in ("out", "in")}
            csr_out, csr_in, slots = csrs_from_route(
                _unpack_route("route", z, device, needs_flags=True),
                tiles["out"], tiles["in"], vroutes["vertex_route_s_from_g"],
                v_pad)
            outgoing = _unpack_directed("out", z, device, slim,
                                        tiles["out"], csr_out)
            incoming = _unpack_directed("in", z, device, slim, tiles["in"],
                                        csr_in)
        else:
            slim = slim or "route.meta" not in z
            outgoing = _unpack_directed("out", z, device, slim)
            incoming = _unpack_directed("in", z, device, slim)
            slots = (in_route_slots(z["in.row_ptr"], incoming.buckets,
                                    incoming.huge, device)
                     if sharded else None)
        return VGLGraph(
            outgoing=outgoing, incoming=incoming,
            advance_route=(None if slim else _unpack_route(
                "route", z, device, needs_flags=True)),
            **vroutes, v=v, v_pad=v_pad, e=e, out_slots=out_slots,
            in_slots=in_slots, graph_format=graph_format,
            in_route_slots=slots if sharded else None, slim=slim)


def save_sharded_graph(sg, path_prefix: str, compressed: bool = False) -> None:
    """Write a ShardedTileGraph as `{prefix}.shard{s}.npz`, one
    save_graph_to_binary_file file per shard, and `{prefix}.meta.json`
    (n_shards, v, v_pad, e, edges_per_shard), as the JAX package does
    (reference ShardedCSRGraph saves per-shard binaries,
    sharded_csr_graph/*.hpp). Uncompressed by default, as there."""
    for s in range(sg.n_shards):
        save_graph_to_binary_file(sg.shard(s), f"{path_prefix}.shard{s}.npz",
                                  compressed=compressed)
    with open(f"{path_prefix}.meta.json", "w") as f:
        json.dump({"n_shards": sg.n_shards, "v": sg.v, "v_pad": sg.v_pad,
                   "e": sg.e,
                   "edges_per_shard": [int(c) for c in sg.edges_per_shard]},
                  f)


# the keys of a direction that the JAX package's slim shard file lacks
# (its slim_value_pull drops the CSR, the renumber maps and the tiles'
# adjacency and edge indices)
_JAX_SLIM_DROPS = (*_CSR_KEYS, "sorted_to_orig", "orig_to_sorted", "adj",
                   "eidx")


def _jax_slim_drops(key: str) -> bool:
    return key.split(".")[0] in ("out", "in") \
        and key.split(".")[-1] in _JAX_SLIM_DROPS


def save_jax_slim_sharded(src_prefix: str, dst_prefix: str) -> None:
    """Write the sharded graph saved at src_prefix (full shards, by either
    package) as the JAX package's slim shards at dst_prefix: each shard's
    file without the keys that its slim save leaves out, the meta file as
    it is. The JAX package loads them as it loads its own slim shards, and
    so does load_sharded_graph (rebuilding the CSRs)."""
    with open(f"{src_prefix}.meta.json") as f:
        n_shards = json.load(f)["n_shards"]
    for s in range(n_shards):
        with np.load(f"{src_prefix}.shard{s}.npz") as z:
            if "route.meta" not in z:
                raise ValueError(f"{src_prefix}.shard{s}.npz: no advance "
                                 "route (a slim shard of the port's)")
            kept = {k: z[k] for k in z.files if not _jax_slim_drops(k)}
        np.savez(f"{dst_prefix}.shard{s}.npz", **kept)
    shutil.copyfile(f"{src_prefix}.meta.json", f"{dst_prefix}.meta.json")


def save_sharded_weights(slot_weights, path_prefix: str) -> None:
    """Write each shard's incoming edge weights in route-slot order (f32
    [n]: parallel/sharded.route_slot_weights, or the JAX package's
    EdgeArray.incoming.slot_flat) as `{prefix}.weights{s}.npy`, the JAX
    package's files (its persistence.py:177-185), so either package reads
    the other's."""
    for s, w in enumerate(slot_weights):
        save_shard_weights(w, path_prefix, s)


def save_shard_weights(w, path_prefix: str, s: int) -> None:
    """Shard s's file of save_sharded_weights (f32 [n], route-slot
    order), for a builder that writes each shard on its own."""
    w = w.cpu().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
    np.save(f"{path_prefix}.weights{s}.npy", w.astype(np.float32, copy=False))


def load_sharded_weights(path_prefix: str, n_shards: int,
                         device="cuda") -> torch.Tensor:
    """The shards' route-slot weights as f32 [S, n] on `device`
    (device="cpu": host memory, the reference's as_numpy=True);
    parallel/sharded.slot_weights_stacked lays them out for the pull."""
    return torch.from_numpy(np.stack([
        np.load(f"{path_prefix}.weights{s}.npy").astype(np.float32,
                                                         copy=False)
        for s in range(n_shards)])).to(device)


def load_sharded_graph(path_prefix: str, device="cuda"):
    """Read a sharded graph saved by either package onto `device`."""
    from ..parallel.shard_build import ShardedTileGraph
    with open(f"{path_prefix}.meta.json") as f:
        meta = json.load(f)
    shards = tuple(load_graph_from_binary_file(f"{path_prefix}.shard{s}.npz",
                                               device=device)
                   for s in range(meta["n_shards"]))
    for s, g in enumerate(shards):
        if (g.v, g.v_pad) != (meta["v"], meta["v_pad"]):
            raise ValueError(f"{path_prefix}.shard{s}.npz: v, v_pad = "
                             f"{g.v}, {g.v_pad}; the meta file says "
                             f"{meta['v']}, {meta['v_pad']}")
    return ShardedTileGraph(
        shards=shards,
        edges_per_shard=tuple(int(c) for c in meta["edges_per_shard"]),
        n_shards=meta["n_shards"], v=meta["v"], v_pad=meta["v_pad"],
        e=meta["e"])
