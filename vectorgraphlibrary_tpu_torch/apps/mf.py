"""Max-flow benchmark app (port of apps/mf.py).

    python -m vectorgraphlibrary_tpu_torch.apps.mf -s 18 -e 32 -it 3 -check

As the JAX app: the graph without self-loops and duplicate edges, capacities
from numpy's default_rng(seed).integers(1, 100), the sink the vertex of
largest in-degree other than the source; a round is one
vgl_ford_fulkerson call (its MTEPS |E| / round time) and the check compares
the flow with seq_ford_fulkerson's.
"""
from __future__ import annotations

import sys

import numpy as np

from ..io.edges_container import EdgesContainer
from ..models import mf
from .app_common import run_app


def prepare(ec: EdgesContainer, seed: int) -> EdgesContainer:
    """The app's max-flow input, made once per (container, seed) and kept
    with the container (EdgesContainer.derived): mf.build_residual keeps
    the residual graph on the container it gets, so rounds must reuse it."""
    def build():
        dedup = ec.remove_self_loops_and_duplicates()
        rng = np.random.default_rng(seed)
        return EdgesContainer(
            dedup.src_ids, dedup.dst_ids, dedup.vertices_count,
            rng.integers(1, 100, dedup.edges_count).astype(np.float32))
    return ec.derived(("mf_input", seed), build)


def sink_for(ec2: EdgesContainer, source: int) -> int:
    """The vertex of largest in-degree other than the source."""
    indeg = np.bincount(ec2.dst_ids, minlength=ec2.vertices_count)
    return int(np.argmax(np.where(np.arange(len(indeg)) != source, indeg,
                                  -1)))


def run_round(ec, graph, weights, source, cfg):
    ec2 = prepare(ec, cfg.seed)
    sink = sink_for(ec2, source)
    flow = mf.vgl_ford_fulkerson(ec2, graph, source, sink)
    return np.asarray([flow, sink])


def check_round(ec, graph, weights, source, result, cfg) -> int:
    ec2 = prepare(ec, cfg.seed)
    flow, sink = float(result[0]), int(result[1])
    want = mf.seq_ford_fulkerson(ec2, source, sink)
    errors = 0 if abs(flow - want) < 1e-6 else 1
    print(f"error count: {errors}")
    return errors


if __name__ == "__main__":
    sys.exit(run_app("mf", run_round, check_round))
