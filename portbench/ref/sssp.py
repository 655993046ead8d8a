"""Plain single-source shortest paths from the edge list and its weights:
Bellman-Ford in float64, each sweep relaxing the out-edges of the vertices
whose distance fell in the last, to the fixpoint; unreachable +inf.

The check takes the largest |distance - reference| / max(reference, 1)
over the vertices; a vertex reached on one side only reads +inf.

control=True computes it in bfloat16: distances and weights rounded to
bfloat16 after every operation, the arithmetic between in float32.
Imports torch only."""
from __future__ import annotations

import torch

CONTROL = "bfloat16"
LIMITS = {"sssp_rel_err": 1e-4}


def solve(src, dst, w, v: int, root, params: dict, control: bool = False):
    """Distances [v] (float64; float32 holding bfloat16 values with
    control)."""
    dt = torch.float32 if control else torch.float64

    def rnd(x):
        return x.to(torch.bfloat16).to(dt) if control else x

    src, dst = src.long(), dst.long()
    w = rnd(w.to(dt))
    dist = torch.full((v,), float("inf"), dtype=dt, device=src.device)
    dist[root] = 0.0
    active = torch.zeros(v, dtype=torch.bool, device=src.device)
    active[root] = True
    while bool(active.any()):
        m = active[src]
        s, d = src[m], dst[m]
        cand = rnd(dist[s] + w[m])
        new = dist.scatter_reduce(0, d, cand, "amin")
        active = new < dist
        dist = new
    return dist


def compare(got, want) -> dict:
    """got: the distances under test [v]; want: solve's [v]."""
    got, want = got.to(want.device, torch.float64), want.double()
    both = torch.isinf(got) & torch.isinf(want)
    err = (got - want).abs() / want.clamp(min=1.0)
    err = torch.where(both, 0.0, torch.nan_to_num(err, nan=float("inf")))
    return {"sssp_rel_err": float(err.max())}
