"""A directed Chung-Lu edge list with power-law expected degrees, drawn on
the card.

The draw of the port's apps/make_lj_replica.py: expected degrees
w_i = (i + 1)^(-1 / (gamma - 1)) over the ranks 1..v, scaled to sum to e,
capped at max_degree and scaled to sum to e again; each edge's source and
destination drawn independently in proportion to w by inverse-CDF
sampling (float64 uniforms searched in the float64 normalised cumulative
sum). Repeated edges and self-loops stay. It is the same distribution as
the app's numpy draw, not the same bytes.
"""
from __future__ import annotations

import torch


def edges(params: dict, seed: int, device) -> tuple:
    """(src, dst, v): int32 [E] each on `device`, from `seed`."""
    v, e = int(params["vertices"]), int(params["edges"])
    gamma, cap = float(params["gamma"]), float(params["max_degree"])
    f64 = torch.float64
    w = torch.arange(1, v + 1, dtype=f64, device=device) \
        .pow_(-1.0 / (gamma - 1.0))
    w.mul_(e / w.sum())
    w.clamp_(max=cap)
    w.mul_(e / w.sum())
    cdf = torch.cumsum(w, 0)
    cdf.div_(cdf[-1].clone())
    del w
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = []
    for _ in range(2):       # every source first, then every destination
        ids = torch.empty(e, dtype=torch.int32, device=device)
        step = 1 << 24
        for lo in range(0, e, step):
            u = torch.rand(min(step, e - lo), dtype=f64, generator=gen,
                           device=device)
            ids[lo:lo + u.numel()] = torch.searchsorted(cdf, u, out_int32=True)
        out.append(ids.clamp_(max=v - 1))
    return out[0], out[1], v
