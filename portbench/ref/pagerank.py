"""Plain PageRank in float64 from the edge list: the semantics of the
port's vgl_page_rank (rank flows src -> dst; self-loops left out of the
messages and the out-degrees; dangling vertices' rank spread evenly;
k = (1 - d) / |V|; start 1 / |V|), a fixed count of iterations.

control=True computes it in bfloat16 instead: every stored vector (ranks,
messages, sums) rounded to bfloat16, the arithmetic between in float32.
Imports torch only."""
from __future__ import annotations

import torch

CONTROL = "bfloat16"
# the largest |rank - reference| / reference over the vertices
LIMITS = {"pagerank_rel_err": 1e-4}


def solve(src, dst, w, v: int, root, params: dict, control: bool = False):
    """Ranks [v] (float64; float32 holding bfloat16 values with control)."""
    dt = torch.float32 if control else torch.float64

    def rnd(x):
        return x.to(torch.bfloat16).to(dt) if control else x

    src, dst = src.long(), dst.long()
    keep = src != dst
    s, d = src[keep], dst[keep]
    del keep
    outdeg = torch.bincount(s, minlength=v).to(dt)
    rev = rnd(torch.where(outdeg > 0, 1.0 / outdeg.clamp(min=1), 0.0))
    dangling = outdeg == 0
    damping = float(params["damping"])
    k = (1.0 - damping) / v
    ranks = rnd(torch.full((v,), 1.0 / v, dtype=dt, device=src.device))
    for _ in range(int(params["iterations"])):
        spread = rnd(ranks[dangling].sum() / v)
        msg = rnd(ranks * rev)
        acc = rnd(torch.zeros_like(ranks).index_add_(0, d, msg[s]))
        ranks = rnd(k + damping * (acc + spread))
    return ranks


def compare(got, want) -> dict:
    """got: the ranks under test [v]; want: solve's [v]."""
    got = got.to(want.device, torch.float64)
    rel = ((got - want.double()).abs() / want.double().abs()).max()
    return {"pagerank_rel_err": float(torch.nan_to_num(rel, nan=float("inf")))}
