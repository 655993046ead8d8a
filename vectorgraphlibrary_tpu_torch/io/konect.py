"""KONECT / edge-list text import (copied from
vectorgraphlibrary_tpu/io/konect.py, numpy only; reference
GraphGenerationAPI txt import, `graph_generation/graph_generation.hpp:5-48`
KONECT path). Accepts whitespace-separated "src dst [weight]" lines; '%' or
'#' comment lines skipped; ids normalized to 0-based dense range."""
from __future__ import annotations

import gzip

import numpy as np

from .edges_container import EdgesContainer


def import_konect(path: str, directed: bool = True) -> EdgesContainer:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = np.loadtxt(
            (line for line in f
             if line.strip() and not line.lstrip().startswith(("%", "#"))),
            dtype=np.float64, ndmin=2)
    s = data[:, 0].astype(np.int64)
    d = data[:, 1].astype(np.int64)
    weights = data[:, 2].astype(np.float32) if data.shape[1] > 2 else None
    # normalize ids to dense 0-based
    uniq, inv = np.unique(np.concatenate([s, d]), return_inverse=True)
    s2 = inv[:len(s)].astype(np.int32)
    d2 = inv[len(s):].astype(np.int32)
    v = len(uniq)
    if not directed:
        s2, d2 = np.concatenate([s2, d2]), np.concatenate([d2, s2])
        if weights is not None:
            weights = np.concatenate([weights, weights])
    return EdgesContainer(s2, d2, v, weights)
