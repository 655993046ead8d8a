"""CC benchmark app (port of apps/cc.py).

    python -m vectorgraphlibrary_tpu_torch.apps.cc -s 20 -e 16 -it 3 -check

Default (or -sv): Shiloach-Vishkin; -bfs-based: the BFS-based variant. A
round labels the whole graph; its MTEPS is |E| / round time, as in the JAX
app.
"""
from __future__ import annotations

import sys

from ..models import cc
from ..utils import verify
from .app_common import run_app


def run_round(ec, graph, weights, source, cfg):
    if cfg.algorithm_variant == "bfs_based":
        return cc.vgl_bfs_based(graph).values
    labels, _ = cc.vgl_shiloach_vishkin(graph)   # -sv default
    return labels.values


def check_round(ec, graph, weights, source, result, cfg) -> int:
    got = result[:graph.v].cpu().numpy()
    want = cc.seq_cc(ec)
    return verify.equal_components(got, want)


if __name__ == "__main__":
    sys.exit(run_app("cc", run_round, check_round, needs_source=False))
