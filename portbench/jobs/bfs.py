"""BFS jobs: the port's models/bfs.vgl_bfs_device (direction-optimizing,
state on the device) from one root each. Work: |E| per root (bench.py's
formula)."""
from __future__ import annotations

REF = "bfs"
METRIC = "bfs_gteps"
PER_UNIT = 1e9
NEEDS_ROOTS = True
NEEDS_WEIGHTS = False


def work(v: int, e: int, params: dict) -> int:
    return e


def entry(params: dict):
    """-> run(graph, weights, root): the job's VertexArray."""
    from vectorgraphlibrary_tpu_torch.models import bfs

    def run(graph, weights, root):
        return bfs.vgl_bfs_device(graph, root)
    return run
