"""SCC benchmark app (port of apps/scc.py).

    python -m vectorgraphlibrary_tpu_torch.apps.scc -s 18 -e 32 -it 3 -check

A round labels the whole graph by trim + forward-backward; its MTEPS is
|E| / round time, as in the JAX app. -check compares the components with
seq_scc up to relabelling.
"""
from __future__ import annotations

import sys

from ..models import scc
from ..utils import verify
from .app_common import run_app


def run_round(ec, graph, weights, source, cfg):
    return scc.vgl_forward_backward(graph).values


def check_round(ec, graph, weights, source, result, cfg) -> int:
    return verify.equal_components(result[:graph.v].cpu().numpy(),
                                   scc.seq_scc(ec))


if __name__ == "__main__":
    sys.exit(run_app("scc", run_round, check_round, needs_source=False))
