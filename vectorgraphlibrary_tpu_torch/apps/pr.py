"""PageRank benchmark app (port of apps/pr.py).

    python -m vectorgraphlibrary_tpu_torch.apps.pr -s 18 -e 32 -it 3 -check

The skeleton (warmup, measured rounds, -check, AVG_PERF) is
app_common.run_app. A round is one 100-iteration PageRank; its MTEPS is |E| /
round time, as in the JAX app.
"""
from __future__ import annotations

import sys

from ..config import TraversalDirection
from ..graph.vertices import VertexArray, as_original_numpy
from ..models import pr
from ..utils import verify
from .app_common import run_app

# fixed iteration count on BOTH the device run and the oracle: the device
# convergence test runs in f32 and the oracle's in f64, so convergence-mode
# runs stop at different iterations and fail the ranking check spuriously
_PR_ITERS = 100


def run_round(ec, graph, weights, source, cfg):
    ranks, _ = pr.vgl_page_rank(graph, max_iterations=_PR_ITERS,
                                use_convergence=False)
    return ranks.values


def check_round(ec, graph, weights, source, result, cfg) -> int:
    arr = VertexArray(values=result, direction=TraversalDirection.GATHER)
    got = as_original_numpy(arr, graph)
    want = pr.seq_page_rank(ec, max_iterations=_PR_ITERS, use_convergence=False)
    return verify.verify_ranking_results(got, want)


if __name__ == "__main__":
    sys.exit(run_app("pr", run_round, check_round, needs_source=False))
