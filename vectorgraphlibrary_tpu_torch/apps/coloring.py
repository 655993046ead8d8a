"""Graph coloring benchmark app (port of apps/coloring.py).

    python -m vectorgraphlibrary_tpu_torch.apps.coloring -s 18 -e 32 -it 3 -check

A round colors the whole graph with core extraction (the dense core
first-fit on the host, the rest in speculative Jones-Plassmann rounds on the
device); -check runs verify_colors (no edge joins two distinct vertices of
one color).
"""
from __future__ import annotations

import sys

from ..models import coloring
from ..utils import verify
from .app_common import run_app


def run_round(ec, graph, weights, source, cfg):
    colors, _ = coloring.vgl_coloring(graph, ec=ec)
    return colors.values


def check_round(ec, graph, weights, source, result, cfg) -> int:
    return verify.verify_colors(ec, result[:graph.v].cpu().numpy())


if __name__ == "__main__":
    sys.exit(run_app("coloring", run_round, check_round, needs_source=False))
