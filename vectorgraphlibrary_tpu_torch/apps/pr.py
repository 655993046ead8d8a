"""PageRank benchmark app (port of apps/pr.py with apps/app_common.run_app).

    python -m vectorgraphlibrary_tpu_torch.apps.pr -s 18 -e 32 -it 3 -check

Follows the reference main shape (`apps/bfs/bfs.cpp:15-62`): parse → generate
and import the graph → one untimed warmup round → measured rounds, each
checked against the sequential oracle with -check → AVG_PERF. A round is one
100-iteration PageRank; its MTEPS is |E| / round time, as in the JAX app.
"""
from __future__ import annotations

import sys
import time

import torch

from ..config import SyntheticGraphType, TraversalDirection
from ..graph.device import import_graph
from ..graph.vertices import VertexArray, as_original_numpy
from ..io import generation
from ..models import pr
from ..runtime import cli
from ..runtime.perf_stats import PerformanceStats
from ..utils import verify

# fixed iteration count on BOTH the device run and the oracle: the device
# convergence test runs in f32 and the oracle's in f64, so convergence-mode
# runs stop at different iterations and fail the ranking check spuriously
_PR_ITERS = 100


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_round(ec, graph, cfg) -> torch.Tensor:
    ranks, _ = pr.vgl_page_rank(graph, max_iterations=_PR_ITERS,
                                use_convergence=False)
    return ranks.values


def check_round(ec, graph, result, cfg) -> int:
    arr = VertexArray(values=result, direction=TraversalDirection.GATHER)
    got = as_original_numpy(arr, graph)
    want = pr.seq_page_rank(ec, max_iterations=_PR_ITERS, use_convergence=False)
    return verify.verify_ranking_results(got, want)


def run_app(app_name: str, run_round, check_round=None, argv=None) -> int:
    """run_round(ec, graph, cfg) -> result tensor; check_round(ec, graph,
    result, cfg) -> error count."""
    cfg = cli.parse_args(argv, app_name)
    device = torch.device(cfg.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("-dev cuda: no CUDA device is available "
                               "(-dev cpu runs the plain PyTorch versions)")
        print(f"VGL (PyTorch) init: {torch.cuda.device_count()} device(s): "
              f"{torch.cuda.get_device_name(device)}")
    else:
        print(f"VGL (PyTorch) init: device {device}")
    kind = "rmat" if cfg.synthetic_type == SyntheticGraphType.RMAT else "ru"
    ec = generation.generate(kind, cfg.scale, cfg.avg_degree, cfg.seed,
                             weighted=False)
    graph = import_graph(ec, cfg, device=device)
    print(f"graph: |V|={graph.v} |E|={graph.e}")

    # one untimed warmup round: the kernel build and first launches would
    # otherwise land in the first measured round
    run_round(ec, graph, cfg)
    _sync(device)

    stats = PerformanceStats()
    total_errors = 0
    for _ in range(cfg.iterations):
        t0 = time.perf_counter()
        result = run_round(ec, graph, cfg)
        _sync(device)
        stats.save_algorithm_performance_stats(app_name,
                                               time.perf_counter() - t0,
                                               graph.e)
        if cfg.check and check_round is not None:
            total_errors += check_round(ec, graph, result, cfg)
    stats.report_performance(app_name)
    return 1 if (cfg.check and total_errors > 0) else 0


if __name__ == "__main__":
    sys.exit(run_app("pr", run_round, check_round))
