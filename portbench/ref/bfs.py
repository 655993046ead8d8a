"""Plain level-synchronous BFS from the edge list: root level 1, each
level the out-neighbours of the last that no level holds yet, unreached
-1 (the port's convention). Levels are exact, so there is no lower
precision (CONTROL None). Imports torch only."""
from __future__ import annotations

import torch

CONTROL = None
LIMITS = {"bfs_mismatched": 0}


def solve(src, dst, w, v: int, root, params: dict, control: bool = False):
    """Levels [v] (int32)."""
    src, dst = src.long(), dst.long()
    levels = torch.full((v,), -1, dtype=torch.int32, device=src.device)
    levels[root] = 1
    frontier = torch.zeros(v, dtype=torch.bool, device=src.device)
    frontier[root] = True
    cur = 1
    while True:
        new = torch.zeros_like(frontier)
        new[dst[frontier[src]]] = True
        new &= levels < 0
        if not bool(new.any()):
            return levels
        cur += 1
        levels[new] = cur
        frontier = new


def compare(got, want) -> dict:
    """got: the levels under test [v]; want: solve's [v]."""
    got = got.to(want.device, torch.int32)
    return {"bfs_mismatched": int((got != want).sum())}
