"""PageRank jobs: the port's models/pr.vgl_page_rank with a fixed count of
iterations and no convergence test (GAP's 20), so that every job does the
same work. Work: |E| per iteration (bench.py's formula)."""
from __future__ import annotations

REF = "pagerank"
METRIC = "pagerank_mteps"
PER_UNIT = 1e6
NEEDS_ROOTS = False
NEEDS_WEIGHTS = False


def work(v: int, e: int, params: dict) -> int:
    return e * int(params["iterations"])


def entry(params: dict):
    """-> run(graph, weights, root): the job's VertexArray."""
    from vectorgraphlibrary_tpu_torch.models import pr
    iterations, damping = int(params["iterations"]), float(params["damping"])

    def run(graph, weights, root):
        return pr.vgl_page_rank(graph, damping=damping,
                                max_iterations=iterations,
                                use_convergence=False)[0]
    return run
