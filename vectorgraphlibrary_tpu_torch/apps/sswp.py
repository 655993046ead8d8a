"""SSWP benchmark app (port of apps/sswp.py).

    python -m vectorgraphlibrary_tpu_torch.apps.sswp -s 20 -e 16 -it 3 -check

A round is one widest-paths run from a random non-isolated source; its MTEPS
is |E| / round time, as in the JAX app.
"""
from __future__ import annotations

import sys

from ..graph.vertices import as_original_numpy
from ..models import sswp
from ..utils import verify
from .app_common import run_app


def run_round(ec, graph, weights, source, cfg):
    caps, _ = sswp.vgl_widest_paths(graph, weights, source)
    return caps


def check_round(ec, graph, weights, source, result, cfg) -> int:
    got = as_original_numpy(result, graph)
    want = sswp.seq_widest_paths(ec, source)
    return verify.verify_results(got, want)


if __name__ == "__main__":
    sys.exit(run_app("sswp", run_round, check_round, need_weights=True))
