"""Shared benchmark-app skeleton (port of apps/app_common.py).

Every app follows the reference main shape (`apps/bfs/bfs.cpp:15-62`):
parse → init (runtime.init_library) → load or generate the edges, import
them and bind edge weights where the app needs them (runtime.prepare_graph)
→ one untimed warmup round → measured rounds, each checked against the
sequential oracle with -check (traced when VGL_TRACE_DIR is set) → the
per-primitive profiling pass (runtime/prim_profile.py; -no-prim-stats skips
it) → the per-primitive table → AVG_PERF.

    python -m vectorgraphlibrary_tpu_torch.apps.<app> -s 14 -e 16 -it 3 -check

`-dev` defaults to cuda and raises without a card; `-dev cpu` runs the
kernels' plain PyTorch versions. `weights` is the graph's EdgeArray for an
app with need_weights and None for every other.
"""
from __future__ import annotations

import time

import torch

from ..models import common
from ..runtime import cli, prim_profile, profiling, runtime
from ..runtime.perf_stats import performance_stats


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_app(app_name: str, run_round, check_round=None,
            need_weights: bool = False, needs_source: bool = True,
            argv=None) -> int:
    """run_round(ec, graph, weights, source, cfg) -> result;
    check_round(ec, graph, weights, source, result, cfg) -> error count.
    The warmup round's source is select_random_source(seed=cfg.seed), round
    it's seed=cfg.seed + it (None for apps without a source). The rounds'
    MTEPS go to the global runtime.perf_stats.performance_stats."""
    cfg = cli.parse_args(argv, app_name)
    device = runtime.init_library(cfg)
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

    runtime.start_measuring_stats()
    total_errors = 0
    with profiling.trace(profiling.trace_dir_from_env()):
        for it in range(cfg.iterations):
            src = source(cfg.seed + it)
            t0 = time.perf_counter()
            with profiling.step_annotate(app_name, it):
                result = run_round(ec, graph, weights, src, cfg)
                _sync(device)
            performance_stats.save_algorithm_performance_stats(
                app_name, time.perf_counter() - t0, graph.e)
            if cfg.check and check_round is not None:
                total_errors += check_round(ec, graph, weights, src, result,
                                            cfg)
    performance_stats.stop_measuring_stats()   # the rounds' wall time
    if cfg.prim_stats:
        prim_profile.profile_graph_primitives(graph, weights)
    performance_stats.print_timers_stats()
    runtime.report_performance(app_name)
    runtime.finalize_library()
    return 1 if (cfg.check and total_errors > 0) else 0
