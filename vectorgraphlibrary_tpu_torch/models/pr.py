"""PageRank (port of vectorgraphlibrary_tpu/models/pr.py).

Capability match for the reference PR (`algorithms/pr/pr.hpp:6-148`): damping
d=0.85, k=(1-d)/|V|, self-loop-excluded degrees, dangling-vertex
redistribution, fixed iteration count or an L1 convergence test. Each
iteration is one pull over incoming edges (messages
old_rank[u]/outdeg_wo_loops[u]) in an eager loop: one CSR pull kernel
launch plus elementwise work; the out-degrees take one vertex route before
the loop.

Rank flows src→dst along edge direction, as in the JAX package (the C++
reference propagates along reversed edges, pr.hpp:110-117); the bundled oracle
`seq_page_rank` matches.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import TraversalDirection
from ..graph.device import VGLGraph
from ..graph.vertices import VertexArray
from ..ops.advance import advance_cells, advance_pull_value
from ..ops.compute import compute
from ..ops.reduce import reduce as vgl_reduce
from ..ops.route import apply_route
from ..runtime.profiling import annotate
from .common import read_scalar

G = TraversalDirection.GATHER


def _pr_run(graph: VGLGraph, max_iterations: int, use_convergence: bool,
            damping: float, tol: float) -> tuple[torch.Tensor, int]:
    dev = graph.device
    v = graph.v
    f32 = torch.float32
    with annotate("vgl.pr"):
        with annotate("vgl.pr.constants"):
            ids = torch.arange(graph.v_pad, dtype=torch.int32, device=dev)
            real = ids < v
            zero = torch.zeros((), dtype=f32, device=dev)

            # self-loop counts per vertex: one cell pass over incoming tiles
            loops = advance_cells(
                graph,
                lambda src_ids, dst_ids, w: (src_ids == dst_ids).to(
                    torch.int32),
                "add", direction=G)
            # out-degrees in gather order: one inverse vertex route
            outdeg = apply_route(graph.vertex_route_s_from_g,
                                 graph.outgoing.degrees, inverse=True)
            outdeg_wo = torch.where(real, outdeg - loops, 0)
            rev_deg = torch.where(outdeg_wo > 0, 1.0 / outdeg_wo.to(f32),
                                  zero)
            dangling_mask = real & (outdeg_wo == 0)

            # f32 scalars, as the reference computes them
            damping_t = torch.tensor(damping, dtype=f32, device=dev)
            k = (1.0 - damping_t) / v
            ranks = torch.where(
                real, torch.tensor(1.0 / v, dtype=f32, device=dev), zero)

        it = 0
        while it < max_iterations:
            with annotate("vgl.pr.iteration"):
                dangling = vgl_reduce(
                    graph, torch.where(dangling_mask, ranks, zero), "add",
                    direction=G) / v
                # one restricted-form advance: the pull kernel skips
                # self-loops
                acc = advance_pull_value(graph, ranks * rev_deg, "add",
                                         exclude_self_loops=True,
                                         direction=G)
                new_ranks = compute(
                    graph, {"r": ranks},
                    lambda ids, degs, arr: {
                        "r": k + damping_t * (acc + dangling)},
                    direction=G)["r"]
                delta = vgl_reduce(graph, (new_ranks - ranks).abs(), "add",
                                   direction=G)
                ranks = new_ranks
                it += 1
                # the convergence test reads delta on the host: one sync
                # per iteration, only in that mode
                if use_convergence and not read_scalar(delta > tol):
                    break
    return ranks, it


def vgl_page_rank(graph: VGLGraph, damping: float = 0.85,
                  convergence_factor: float = 1.0e-6,
                  max_iterations: int = 100,
                  use_convergence: bool = True) -> tuple[VertexArray, int]:
    ranks, iters = _pr_run(graph, max_iterations, use_convergence, damping,
                           convergence_factor)
    return VertexArray(values=ranks, direction=G), iters


def seq_page_rank(ec, damping: float = 0.85, convergence_factor: float = 1.0e-6,
                  max_iterations: int = 100, use_convergence: bool = True
                  ) -> np.ndarray:
    """Sequential oracle (reference seq_page_rank analog) — NumPy and scipy,
    original ids. Same fp64 math as the JAX package's oracle, with each
    iteration's scatter-add of ranks[s] / outdeg(s) over the edges as one
    scipy sparse product (the same sums in another order)."""
    import scipy.sparse as sp
    v = ec.vertices_count
    src, dst = ec.src_ids, ec.dst_ids
    nonloop = src != dst
    s, d = src[nonloop], dst[nonloop]
    outdeg_wo = np.bincount(s, minlength=v).astype(np.float64)
    rev = np.where(outdeg_wo > 0, 1.0 / np.maximum(outdeg_wo, 1), 0.0)
    # spread[d, s]: (s -> d edges) / outdeg(s)
    spread = sp.csr_matrix((rev[s], (d, s)), shape=(v, v))
    dangling_mask = outdeg_wo == 0
    k = (1.0 - damping) / v
    ranks = np.full(v, 1.0 / v)
    for _ in range(max_iterations):
        dangling = ranks[dangling_mask].sum() / v
        acc = spread @ ranks
        new_ranks = k + damping * (acc + dangling)
        delta = np.abs(new_ranks - ranks).sum()
        ranks = new_ranks
        if use_convergence and delta < convergence_factor:
            break
    return ranks.astype(np.float32)
