"""Random-walk benchmark app (port of apps/rw.py).

    python -m vectorgraphlibrary_tpu_torch.apps.rw -s 18 -e 32 -it 3 -check

A round walks 1,024 walkers 10 steps from the round's source; -check counts
the walkers whose end lies outside seq_random_walk_reachable (error count).
"""
from __future__ import annotations

import sys

import numpy as np

from ..models import rw
from .app_common import run_app

WALKERS, STEPS = 1024, 10


def run_round(ec, graph, weights, source, cfg):
    return rw.vgl_random_walk(graph, np.full(WALKERS, source, np.int64),
                              walk_length=STEPS, seed=cfg.seed)


def check_round(ec, graph, weights, source, result, cfg) -> int:
    ok = rw.seq_random_walk_reachable(ec, source, walk_length=STEPS)
    errors = int((~ok[result]).sum())
    print(f"error count: {errors}")
    return errors


if __name__ == "__main__":
    sys.exit(run_app("rw", run_round, check_round))
