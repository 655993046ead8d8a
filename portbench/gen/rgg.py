"""A random geometric graph, the rule of DIMACS10's rgg_n_2_*_s0 family,
drawn on the card.

`vertices` points uniform in the unit square [0, 1)^2, in float64, and an
edge between every two points at a distance below r = radius_factor *
sqrt(ln v / v) (the generator of Holtgrewe, Sanders and Schulz, IPDPS
2010, with factor 0.55). The points are bucketed in a grid of cells of
side at least r, so a pair can only lie in one cell or two neighbouring
ones; each cell is compared with itself and with four forward neighbours
((0, 1), (1, -1), (1, 0), (1, 1)), so that each pair is found once. The
points go in chunks, so that the candidate pairs of a chunk fit in
memory. Each pair is stored as two arcs: the pairs first, then their
reverses, as gen/kronecker.py's `symmetrise` does. No self-loops and no
repeats. Vertex i is the i-th point drawn.
"""
from __future__ import annotations

import math

import torch

# forward neighbour cells (dx, dy) besides the cell itself
_FORWARD = ((0, 1), (1, -1), (1, 0), (1, 1))
# points a chunk: about 21 candidates a point at the default factor
_CHUNK = 1 << 20


def radius(params: dict) -> float:
    v = int(params["vertices"])
    return float(params["radius_factor"]) * math.sqrt(math.log(v) / v)


def points(params: dict, seed: int, device) -> torch.Tensor:
    """The [v, 2] float64 points of `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.rand(int(params["vertices"]), 2, dtype=torch.float64,
                      generator=gen, device=device)


def _expand(lo: torch.Tensor, count: torch.Tensor) -> tuple:
    """(i, j) for every i and each j in [lo[i], lo[i] + count[i])."""
    i = torch.repeat_interleave(torch.arange(lo.numel(), device=lo.device),
                                count)
    first = torch.cumsum(count, 0) - count
    j = lo[i] + torch.arange(i.numel(), device=lo.device) - first[i]
    return i, j


def edges(params: dict, seed: int, device) -> tuple:
    """(src, dst, v): int32 [E] each on `device`, from `seed`."""
    v = int(params["vertices"])
    r = radius(params)
    pts = points(params, seed, device)
    side = max(1, int(1.0 / r))              # cells a side, each >= r wide
    cell = (pts * side).long().clamp_(max=side - 1)
    key = cell[:, 0] * side + cell[:, 1]
    order = torch.sort(key, stable=True).indices
    pts, cell, key = pts[order], cell[order], key[order]
    count = torch.bincount(key, minlength=side * side)
    start = torch.cumsum(count, 0) - count
    r2 = r * r
    found_a, found_b = [], []
    for lo in range(0, v, _CHUNK):
        at = torch.arange(lo, min(v, lo + _CHUNK), device=pts.device)
        cx, cy, k = cell[at, 0], cell[at, 1], key[at]
        # the point's own cell: the points after it there
        reach = [(at + 1, start[k] + count[k] - at - 1)]
        for dx, dy in _FORWARD:
            nx, ny = cx + dx, cy + dy
            ok = (nx < side) & (ny >= 0) & (ny < side)
            n = (nx * side + ny).clamp_(0, side * side - 1)
            reach.append((start[n], torch.where(ok, count[n], 0)))
        for first, many in reach:
            i, j = _expand(first, many)
            i = at[i]
            d = pts[i] - pts[j]
            near = (d * d).sum(1) < r2
            found_a.append(order[i[near]])
            found_b.append(order[j[near]])
    a = torch.cat(found_a).to(torch.int32)
    b = torch.cat(found_b).to(torch.int32)
    return torch.cat([a, b]), torch.cat([b, a]), v
