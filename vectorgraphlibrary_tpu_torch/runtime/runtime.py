"""Runtime helpers (the part of vectorgraphlibrary_tpu/runtime/runtime.py
that the ported apps use)."""
from __future__ import annotations

from typing import Optional, Tuple

from ..config import SyntheticGraphType, VGLConfig
from ..graph.device import VGLGraph, import_graph
from ..graph.edges import EdgeArray, build_edge_array_from_host
from ..io import generation
from ..io.edges_container import EdgesContainer


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
    same flags."""
    ec = load_edges(cfg)
    if need_weights and ec.weights is None:
        ec = ec.with_random_weights(cfg.seed + 1)
    host = []
    graph = import_graph(ec, cfg, device=device, _host_out=host)
    weights = None
    if need_weights:
        weights = build_edge_array_from_host(ec.weights, graph, host[0],
                                             host[1])
    return ec, graph, weights
