"""Binary persistence for preprocessed graphs (port of
vectorgraphlibrary_tpu/graph/persistence.py:1-158, without the sharded
save/load, which comes with distribution).

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
- per-slot CSR edge indices (`eidx`, in files of weighted graphs) are not
  read: the port carries no edge weights yet, and they only lay those out.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import GraphFormat
from ..ops.route import (RoutePlan, benes_plan_from_packed, inverse_lanes,
                         pack_masks, plan_from_benes)
from ..ops.route_words import (build_word_masks, split_levels,
                               unpack_word_masks, word_flags)
from .device import DeviceDirectedGraph, TileBucket, VGLGraph, huge_tile

# the value of the "format" key: the only format the port builds
FORMAT = GraphFormat.TILE_CSR.value
_VROUTES = (("vroute", "vertex_route_s_from_g"),
            ("vroute_so", "vertex_route_s_from_o"),
            ("vroute_go", "vertex_route_g_from_o"))
_STAGE_KEYS = ("in_masks", "out_masks", "lane_idx")
# the fused word masks exist from 8 rows of 128 slots on (reference
# route.py:92)
_MIN_WORDS_N = 1024


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _pack_directed(prefix: str, dg: DeviceDirectedGraph, out: dict) -> None:
    out[f"{prefix}.row_ptr"] = _np(dg.row_ptr)
    out[f"{prefix}.col_idx"] = _np(dg.col_idx)
    out[f"{prefix}.degrees"] = _np(dg.degrees)
    out[f"{prefix}.sorted_to_orig"] = _np(dg.sorted_to_orig)
    out[f"{prefix}.orig_to_sorted"] = _np(dg.orig_to_sorted)
    out[f"{prefix}.meta"] = np.asarray([dg.v, dg.v_pad, dg.e, dg.e_pad,
                                        len(dg.buckets),
                                        1 if dg.huge is not None else 0])
    for i, b in enumerate(dg.buckets):
        adj = _np(b.adj)
        if b.width < 128:
            adj = adj.reshape(b.rows_pad * b.width // 128, 128)
        out[f"{prefix}.b{i}.adj"] = adj
        out[f"{prefix}.b{i}.meta"] = np.asarray(
            [b.width, b.row_start, b.rows, b.rows_pad])
    if dg.huge is not None:
        h = dg.huge
        out[f"{prefix}.huge.adj"] = _np(h.adj)
        out[f"{prefix}.huge.seg_ids"] = _np(h.seg_ids)
        out[f"{prefix}.huge.meta"] = np.asarray(
            [h.chunk_w, h.n_rows, h.n_chunks, h.n_chunks_pad])


def _i32(z, key: str, device) -> torch.Tensor:
    a = z[key]
    if a.dtype != np.int32:
        raise ValueError(f"{key}: {a.dtype}, expected int32")
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _unpack_directed(prefix: str, z, device) -> DeviceDirectedGraph:
    v, v_pad, e, e_pad, nb, has_huge = z[f"{prefix}.meta"].tolist()
    buckets = []
    for i in range(nb):
        w, rs, r, rp = z[f"{prefix}.b{i}.meta"].tolist()
        adj = _i32(z, f"{prefix}.b{i}.adj", device)
        if adj.numel() != rp * w:
            raise ValueError(f"{prefix}.b{i}.adj: {tuple(adj.shape)} for "
                             f"{rp} rows of width {w}")
        buckets.append(TileBucket(adj=adj.reshape(rp, w), width=w,
                                  row_start=rs, rows=r, rows_pad=rp))
    huge = None
    if has_huge:
        cw, nr, nc, ncp = z[f"{prefix}.huge.meta"].tolist()
        huge = huge_tile(_i32(z, f"{prefix}.huge.adj", device),
                         z[f"{prefix}.huge.seg_ids"], cw, nr, nc, ncp, device)
    return DeviceDirectedGraph(
        row_ptr=_i32(z, f"{prefix}.row_ptr", device),
        col_idx=_i32(z, f"{prefix}.col_idx", device),
        degrees=_i32(z, f"{prefix}.degrees", device),
        sorted_to_orig=_i32(z, f"{prefix}.sorted_to_orig", device),
        orig_to_sorted=_i32(z, f"{prefix}.orig_to_sorted", device),
        buckets=tuple(buckets), huge=huge, v=v, v_pad=v_pad, e=e, e_pad=e_pad)


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
    """Write `graph` to `path` (.npz) in the JAX package's format. Raises
    ValueError, before anything is written, for a graph imported with
    build_route=False: the format holds the advance route."""
    if graph.advance_route is None:
        raise ValueError("save_graph_to_binary_file: the graph has no "
                         "advance route (imported with build_route=False); "
                         "import it with build_route=True to save it")
    out = {}
    _pack_directed("out", graph.outgoing, out)
    _pack_directed("in", graph.incoming, out)
    out["meta"] = np.asarray([graph.v, graph.v_pad, graph.e, graph.out_slots,
                              graph.in_slots])
    out["format"] = np.asarray([FORMAT], dtype="U16")
    _pack_route("route", graph.advance_route, out)
    for prefix, attr in _VROUTES:
        _pack_route(prefix, getattr(graph, attr), out)
    (np.savez_compressed if compressed else np.savez)(path, **out)


def load_graph_from_binary_file(path: str, device="cuda") -> VGLGraph:
    """Read a graph saved by either package onto `device`."""
    device = torch.device(device)
    with np.load(path) as z:
        fmt = str(z["format"][0])
        if fmt != FORMAT:
            raise ValueError(f"{path}: graph format {fmt!r}; the port reads "
                             f"{FORMAT!r} graphs only")
        v, v_pad, e, out_slots, in_slots = z["meta"].tolist()
        for prefix in ("route",) + tuple(p for p, _ in _VROUTES):
            if f"{prefix}.meta" not in z:
                raise ValueError(f"{path}: no route {prefix!r}")
        return VGLGraph(
            outgoing=_unpack_directed("out", z, device),
            incoming=_unpack_directed("in", z, device),
            advance_route=_unpack_route("route", z, device, needs_flags=True),
            **{attr: _unpack_route(prefix, z, device, needs_flags=False)
               for prefix, attr in _VROUTES},
            v=v, v_pad=v_pad, e=e, out_slots=out_slots, in_slots=in_slots)
