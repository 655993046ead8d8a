"""SSSP jobs: the port's models/sssp.vgl_dijkstra_multi from one source
each (above 2^22 edges the partial-active path: weighted dense pulls and
the sparse push). Work: |E| per source (bench.py's formula)."""
from __future__ import annotations

REF = "sssp"
METRIC = "sssp_mteps"
PER_UNIT = 1e6
NEEDS_ROOTS = True
NEEDS_WEIGHTS = True


def work(v: int, e: int, params: dict) -> int:
    return e


def entry(params: dict):
    """-> run(graph, weights, root): the job's VertexArray ([1, v_pad])."""
    from vectorgraphlibrary_tpu_torch.graph.vertices import VertexArray
    from vectorgraphlibrary_tpu_torch.models import sssp

    def run(graph, weights, root):
        out = sssp.vgl_dijkstra_multi(graph, weights, [root])
        return VertexArray(values=out.values[0], direction=out.direction)
    return run
