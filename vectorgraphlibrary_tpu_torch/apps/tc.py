"""Transitive closure benchmark app (port of apps/tc.py).

    python -m vectorgraphlibrary_tpu_torch.apps.tc -s 18 -e 32 -it 3 -check

A round answers reachability from the round's source: by Purdom's
condensation (default, or -purdoms) or by a BFS on the graph itself
(-bfs-based). -check counts the vertices whose reachability differs from
seq_reachability (error count). Triangle counting (models/tc.
vgl_triangle_count) has no app, as in the JAX package.
"""
from __future__ import annotations

import sys

import numpy as np

from ..models import tc
from .app_common import run_app


def run_round(ec, graph, weights, source, cfg):
    sources = np.asarray([source])
    if cfg.algorithm_variant == "bfs_based":
        return tc.vgl_bfs_based_reachability(graph, sources)
    return tc.reachability(ec, graph, sources)        # -purdoms default


def check_round(ec, graph, weights, source, result, cfg) -> int:
    want = tc.seq_reachability(ec, [source])
    errors = int((np.asarray(result) != want).sum())
    print(f"error count: {errors}")
    return errors


if __name__ == "__main__":
    sys.exit(run_app("tc", run_round, check_round))
