"""The Graph500 Kronecker (R-MAT) edge list, drawn on the card.

2^scale vertices and edge_factor * 2^scale edge tuples. Each tuple takes
one uniform draw per level and descends into the quadrant a, b, c or d
(d = 1 - a - b - c) that the draw falls in, setting one bit of its start
(c, d) and of its end (b, d) per level: the model of the Graph500
specification's generator (section 3) and of the port's
io/generation.rmat. With `symmetrise` (the specification's undirected
graph) every tuple is stored as two arcs, one each way, so the list holds
2 * edge_factor * 2^scale arcs: the tuples first, then their reverses.
Repeated tuples and self-loops stay, as the specification's list keeps
them. The specification's vertex scrambling is the harness's relabelling
by a permutation drawn from --seed.
"""
from __future__ import annotations

import torch


def edges(params: dict, seed: int, device) -> tuple:
    """(src, dst, v): int32 [E] each on `device`, from `seed`."""
    scale, ef = int(params["scale"]), int(params["edge_factor"])
    a, b, c = float(params["a"]), float(params["b"]), float(params["c"])
    v = 1 << scale
    e = v * ef
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    src = torch.zeros(e, dtype=torch.int32, device=device)
    dst = torch.zeros(e, dtype=torch.int32, device=device)
    ab, abc = a + b, a + b + c
    for _ in range(scale):
        u = torch.rand(e, generator=gen, device=device)
        src.bitwise_left_shift_(1).bitwise_or_(u >= ab)
        dst.bitwise_left_shift_(1).bitwise_or_(((u >= a) & (u < ab))
                                               | (u >= abc))
        del u
    if params.get("symmetrise", False):
        src, dst = torch.cat([src, dst]), torch.cat([dst, src])
    return src, dst, v
