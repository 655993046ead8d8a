"""Runtime helpers (the part of vectorgraphlibrary_tpu/runtime/runtime.py
that the ported apps use)."""
from __future__ import annotations

from ..config import SyntheticGraphType, VGLConfig
from ..io import generation
from ..io.edges_container import EdgesContainer


def load_edges(cfg: VGLConfig) -> EdgesContainer:
    """The app's edges: a binary .el_container (-load), a KONECT text file
    (-import), or a synthetic graph (-s/-e, -rmat/-ru, -seed). Synthetic
    graphs are generated without weights, which no ported app reads; their
    edges are the JAX package's for the same flags."""
    if cfg.load_path:
        return EdgesContainer.load_from_binary_file(cfg.load_path)
    if cfg.import_path:
        from ..io.konect import import_konect
        return import_konect(cfg.import_path)
    kind = "rmat" if cfg.synthetic_type == SyntheticGraphType.RMAT else "ru"
    return generation.generate(kind, cfg.scale, cfg.avg_degree, cfg.seed,
                               weighted=False)
