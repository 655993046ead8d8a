"""Connected-components jobs: the port's models/cc.vgl_cc_hybrid with its
default hub (the largest out-degree vertex). Work: |E| per job (bench.py's
formula)."""
from __future__ import annotations

REF = "cc"
METRIC = "cc_mteps"
PER_UNIT = 1e6
NEEDS_ROOTS = False
NEEDS_WEIGHTS = False


def work(v: int, e: int, params: dict) -> int:
    return e


def entry(params: dict):
    """-> run(graph, weights, root): the job's VertexArray."""
    from vectorgraphlibrary_tpu_torch.models import cc

    def run(graph, weights, root):
        return cc.vgl_cc_hybrid(graph)[0]
    return run
