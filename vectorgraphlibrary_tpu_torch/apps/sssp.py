"""SSSP benchmark app (port of apps/sssp.py).

    python -m vectorgraphlibrary_tpu_torch.apps.sssp -s 20 -e 16 -it 3 -check

Default (or -all-active): the all-active Bellman-Ford sweeps, for which
-push and -pull select the same pull kernel. -partial-active: the
work-frontier variant — on the card vgl_dijkstra_partial_device (state in
one ordering, tiered push capacities), on the CPU vgl_dijkstra_partial_active
(the host-loop variant; the JAX app picks between the same two by its
backend). A round is one run from a random non-isolated source; its MTEPS is
|E| / round time, as in the JAX app.
"""
from __future__ import annotations

import sys

from ..graph.vertices import as_original_numpy
from ..models import sssp
from ..utils import verify
from .app_common import run_app


def run_round(ec, graph, weights, source, cfg):
    if cfg.all_active:
        dist, _ = sssp.vgl_dijkstra_all_active(graph, weights, source)
    elif graph.device.type == "cuda":
        dist, _ = sssp.vgl_dijkstra_partial_device(graph, weights, source)
    else:
        dist, _ = sssp.vgl_dijkstra_partial_active(graph, weights, source)
    return dist


def check_round(ec, graph, weights, source, result, cfg) -> int:
    got = as_original_numpy(result, graph)
    want = sssp.seq_dijkstra(ec, source)
    return verify.verify_results(got, want)


if __name__ == "__main__":
    sys.exit(run_app("sssp", run_round, check_round, need_weights=True))
