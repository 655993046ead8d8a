"""Label propagation benchmark app (port of apps/lp.py).

    python -m vectorgraphlibrary_tpu_torch.apps.lp -s 18 -e 32 -it 3 -check

A round runs at most 10 label propagation rounds; -check compares the
labels with seq_label_propagation exactly (its vectorised form, which a CPU
test holds equal to the loop the reference runs).
"""
from __future__ import annotations

import sys

from ..models import lp
from ..utils import verify
from .app_common import run_app

MAX_ITERATIONS = 10


def run_round(ec, graph, weights, source, cfg):
    labels, _ = lp.vgl_label_propagation(graph, max_iterations=MAX_ITERATIONS)
    return labels.values


def check_round(ec, graph, weights, source, result, cfg) -> int:
    return verify.verify_results(
        result[:graph.v].cpu().numpy(),
        lp.seq_label_propagation_fast(ec, max_iterations=MAX_ITERATIONS))


if __name__ == "__main__":
    sys.exit(run_app("lp", run_round, check_round, needs_source=False))
