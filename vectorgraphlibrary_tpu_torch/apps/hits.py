"""HITS benchmark app (port of apps/hits.py).

    python -m vectorgraphlibrary_tpu_torch.apps.hits -s 20 -e 16 -it 3 -check

A round is 20 iterations of vgl_hits; its MTEPS is |E| / round time, as in
the JAX app.
"""
from __future__ import annotations

import sys

from ..models import hits
from ..utils import verify
from .app_common import run_app


def run_round(ec, graph, weights, source, cfg):
    auth, hub = hits.vgl_hits(graph, iterations=20)
    return (auth.values, hub.values)


def check_round(ec, graph, weights, source, result, cfg) -> int:
    auth, hub = result
    wa, wh = hits.seq_hits(ec, iterations=20)
    e1 = verify.verify_ranking_results(auth[:graph.v].cpu().numpy(), wa)
    e2 = verify.verify_ranking_results(hub[:graph.v].cpu().numpy(), wh)
    return e1 + e2


if __name__ == "__main__":
    sys.exit(run_app("hits", run_round, check_round, needs_source=False))
