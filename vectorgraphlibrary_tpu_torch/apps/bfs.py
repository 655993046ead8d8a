"""BFS benchmark app (port of apps/bfs.py).

    python -m vectorgraphlibrary_tpu_torch.apps.bfs -s 20 -e 16 -it 3 -check

Variants: -td pure top-down, -bu bottom-up from level 2 on (vgl_bfs with
alpha=1e-9), default (or -do) the direction-optimizing vgl_bfs_device. A
round is one traversal from a random non-isolated source; its MTEPS is |E| /
round time, as in the JAX app.
"""
from __future__ import annotations

import sys

from ..graph.vertices import as_original_numpy
from ..models import bfs
from ..utils import verify
from .app_common import run_app


def run_round(ec, graph, weights, source, cfg):
    if cfg.algorithm_variant == "td":
        return bfs.vgl_top_down(graph, source)
    if cfg.algorithm_variant == "bu":
        return bfs.vgl_bfs(graph, source, alpha=1e-9)  # bu from level 2 on
    return bfs.vgl_bfs_device(graph, source)


def check_round(ec, graph, weights, source, result, cfg) -> int:
    got = as_original_numpy(result, graph)
    want = bfs.seq_top_down(ec, source)
    return verify.verify_results(got, want)


if __name__ == "__main__":
    sys.exit(run_app("bfs", run_round, check_round))
