"""Runtime facade: init → prepare_graph → run → report (port of
vectorgraphlibrary_tpu/runtime/runtime.py).

Capability match for `VGL_RUNTIME` (`vgl_runtime/vgl_runtime.h:40-59`,
`.hpp:5-128`): init_library (device check and banner), prepare_graph
(generate / load / import, weights), start/stop_measuring_stats,
report_performance (the AVG_PERF contract), finalize_library.

The JAX package's init also turns on its XLA compile cache
(runtime/cache.py); the port compiles no program at run time, and its
kernels' build cache is .cache/torch_kernels/ (ops/cuda/build.py), so it
has no counterpart. Its distributed init comes with the port of
distribution (the JAX package's parallel/), which is not ported yet.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import SyntheticGraphType, VGLConfig
from ..graph.device import VGLGraph, import_graph
from ..graph.edges import EdgeArray, build_edge_array_from_host
from ..io import generation
from ..io.edges_container import EdgesContainer
from .perf_stats import performance_stats


def init_library(cfg: VGLConfig) -> torch.device:
    """Check that cfg.device exists and print the banner (reference
    init.hpp:26-37); returns the device. -dev cuda (the default) raises
    where no card is visible: it never falls back to the CPU."""
    device = torch.device(cfg.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("-dev cuda: no CUDA device is available "
                               "(-dev cpu runs the plain PyTorch versions)")
        print(f"VGL (PyTorch) init: {torch.cuda.device_count()} device(s): "
              f"{torch.cuda.get_device_name(device)}")
    else:
        print(f"VGL (PyTorch) init: device {device}")
    return device


def load_edges(cfg: VGLConfig) -> EdgesContainer:
    """The app's edges: a binary .el_container (-load), a KONECT text file
    (-import), or a synthetic graph (-s/-e, -rmat/-ru, -seed). Synthetic
    graphs are generated without weights (prepare_graph draws them where an
    app needs them); their edges are the JAX package's for the same flags."""
    if cfg.load_path:
        return EdgesContainer.load_from_binary_file(cfg.load_path)
    if cfg.import_path:
        from ..io.konect import import_konect
        return import_konect(cfg.import_path)
    kind = "rmat" if cfg.synthetic_type == SyntheticGraphType.RMAT else "ru"
    return generation.generate(kind, cfg.scale, cfg.avg_degree, cfg.seed,
                               weighted=False)


def prepare_graph(cfg: VGLConfig, need_weights: bool = False, device="cuda"
                  ) -> Tuple[EdgesContainer, VGLGraph, Optional[EdgeArray]]:
    """Generate or load the edges, import them onto `device` and, with
    need_weights, bind the edge weights (the reference's
    VGL_RUNTIME::prepare_graph, vgl_runtime.hpp:27-80). Edges that carry no
    weights get random ones from cfg.seed + 1, the JAX package's for the
    same flags. With cfg.autotune_format (-format auto) utils/autotuner
    picks the format and the huge-row tile parameters first, as in the JAX
    package, and says what it picked."""
    ec = load_edges(cfg)
    if need_weights and ec.weights is None:
        ec = ec.with_random_weights(cfg.seed + 1)
    if cfg.autotune_format:
        from ..utils.autotuner import default_tuner
        cfg = default_tuner().apply(ec, cfg)
        print(f"autotuner: format={cfg.graph_format.value} "
              f"huge_threshold={cfg.huge_degree_threshold}")
    host = []
    graph = import_graph(ec, cfg, cfg.graph_format, device=device,
                         _host_out=host)
    weights = None
    if need_weights:
        weights = build_edge_array_from_host(ec.weights, graph, host[0],
                                             host[1])
    return ec, graph, weights


def start_measuring_stats() -> None:
    performance_stats.start_measuring_stats()


def stop_measuring_stats() -> None:
    performance_stats.stop_measuring_stats()
    performance_stats.print_timers_stats()


def report_performance(name: str) -> float:
    return performance_stats.report_performance(name)


def finalize_library() -> None:
    """Nothing to release: the kernel library stays loaded for the
    process, as the reference's finalize does nothing on one node."""
