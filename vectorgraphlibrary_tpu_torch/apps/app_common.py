"""Shared benchmark-app skeleton (port of apps/app_common.py).

Every app follows the reference main shape (`apps/bfs/bfs.cpp:15-62`):
parse → load or generate the edges, import them and bind edge weights where
the app needs them (runtime.prepare_graph) → one untimed warmup round → measured rounds, each checked against the
sequential oracle with -check → AVG_PERF.

    python -m vectorgraphlibrary_tpu_torch.apps.<app> -s 14 -e 16 -it 3 -check

`-dev` defaults to cuda and raises without a card; `-dev cpu` runs the
kernels' plain PyTorch versions. `weights` is the graph's EdgeArray for an
app with need_weights and None for every other.
"""
from __future__ import annotations

import time

import torch

from ..models import common
from ..runtime import cli, runtime
from ..runtime.perf_stats import PerformanceStats


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_app(app_name: str, run_round, check_round=None,
            need_weights: bool = False, needs_source: bool = True,
            argv=None) -> int:
    """run_round(ec, graph, weights, source, cfg) -> result;
    check_round(ec, graph, weights, source, result, cfg) -> error count.
    The warmup round's source is select_random_source(seed=cfg.seed), round
    it's seed=cfg.seed + it (None for apps without a source)."""
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
    ec, graph, weights = runtime.prepare_graph(cfg, need_weights=need_weights,
                                               device=device)
    print(f"graph: |V|={graph.v} |E|={graph.e}")

    def source(seed):
        return common.select_random_source(ec, seed=seed) \
            if needs_source else None

    # one untimed warmup round: the kernel build and first launches would
    # otherwise land in the first measured round
    run_round(ec, graph, weights, source(cfg.seed), cfg)
    _sync(device)

    stats = PerformanceStats()
    total_errors = 0
    for it in range(cfg.iterations):
        src = source(cfg.seed + it)
        t0 = time.perf_counter()
        result = run_round(ec, graph, weights, src, cfg)
        _sync(device)
        stats.save_algorithm_performance_stats(app_name,
                                               time.perf_counter() - t0,
                                               graph.e)
        if cfg.check and check_round is not None:
            total_errors += check_round(ec, graph, weights, src, result, cfg)
    stats.report_performance(app_name)
    return 1 if (cfg.check and total_errors > 0) else 0
