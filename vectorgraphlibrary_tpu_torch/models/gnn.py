"""GraphSAGE: neighbourhood aggregation, sampling and a 2-layer model (port
of vectorgraphlibrary_tpu/models/gnn.py).

- Full aggregation is a sparse-dense product: per destination, the sum of
  its in-neighbours' feature rows, one launch of the feature-row pull kernel
  (ops/cuda/pull_rows.py) over the direction's CSR. Its gradient is the same
  kernel over the transposed CSR (rows u, columns v, both in the direction's
  sorted ordering), which the graph builds once per direction, on the device,
  by a stable sort of col_idx, and keeps (VGLGraph.derived). That costs two
  int32 arrays of the CSR's size; the other way, the opposite direction's
  CSR, would need two F-wide vertex permutations per backward pass (2 x 2 x
  v_pad x F x 4 bytes moved, about 4 GB at RMAT-20 and F = 256), against the
  CSR's own 67 MB of columns. The kernel launches only where autograd asks
  for the gradient: a full-aggregation training step launches it three
  times (layer 1 forward, layer 2 forward, layer 2 backward to h; the input
  features take no gradient). The reference's MXU group-matrix branch for
  narrow buckets (gnn.py:54-66) has no counterpart: one CSR pass covers
  every degree class.
- Sampled aggregation: k uniform neighbours per vertex (row start + a
  random offset), then a gather and a mean in plain PyTorch, as the JAX
  package computes it outside Pallas.
- The model: SageParams (an nn.Module), sage_forward, and a cross-entropy
  train step on torch.optim; autograd stands for jax.value_and_grad.

Orderings as in the reference: features and results are in the GATHER
ordering; sample_neighbors defaults to SCATTER and returns SCATTER-sorted
ids, which sage_forward uses as row indices of GATHER-ordered features
unchanged (reference gnn.py:91-110, 132-141). The port reproduces that.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..config import TraversalDirection
from ..graph.device import DeviceDirectedGraph, VGLGraph
from ..ops.cuda.pull_rows import RowCSR, pull_rows

G, S = TraversalDirection.GATHER, TraversalDirection.SCATTER


def _csr(graph: VGLGraph, direction: TraversalDirection) -> RowCSR:
    """The direction's CSR, as pull_rows takes it."""
    dg = graph.direction(direction)
    return graph.derived(("pull_rows", direction),
                         lambda: RowCSR(dg.row_ptr, dg.col_idx))


def transpose_csr(row_ptr: torch.Tensor, col_idx: torch.Tensor, n: int,
                  e: int) -> tuple:
    """(row_ptr, col_idx) of the transpose of an n x n CSR of e edges (its
    col_idx may be padded past e): row u lists, in ascending order, the
    rows v whose columns hold u (as often as they do). One stable sort of
    col_idx on its device."""
    cols = col_idx[:e]
    rows = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int32, device=cols.device),
        (row_ptr[1:] - row_ptr[:-1]).long(), output_size=e)
    order = torch.sort(cols, stable=True).indices
    t_ptr = torch.zeros(n + 1, dtype=torch.int32, device=cols.device)
    t_ptr[1:] = torch.cumsum(torch.bincount(cols.long(), minlength=n), 0)
    return t_ptr, rows[order].contiguous()


def transposed_csr(dg: DeviceDirectedGraph) -> tuple:
    """transpose_csr of dg's CSR, in dg's sorted ordering."""
    return transpose_csr(dg.row_ptr, dg.col_idx, dg.v_pad, dg.e)


def _csr_t(graph: VGLGraph, direction: TraversalDirection) -> RowCSR:
    """The direction's transposed CSR, as pull_rows takes it."""
    return graph.derived(("pull_rows_t", direction), lambda: RowCSR(
        *transposed_csr(graph.direction(direction))))


class _NeighbourSum(torch.autograd.Function):
    """out = pull_rows over the direction's CSR; its gradient the same
    kernel over the transposed CSR."""

    @staticmethod
    def forward(ctx, x, graph, direction):
        ctx.graph, ctx.direction = graph, direction
        return pull_rows(_csr(graph, direction), x.contiguous())

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        return (pull_rows(_csr_t(ctx.graph, ctx.direction), grad.contiguous()),
                None, None)


def aggregate_sum_count(graph: VGLGraph, feats: torch.Tensor,
                        direction: TraversalDirection = G
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Neighbour-feature sums and neighbour counts: [v_pad, F] -> ([v_pad,
    F], f32 [v_pad]) in `direction`'s sorted ordering (neighbours =
    in-neighbours for GATHER). The count is the row's length in the
    direction's CSR; the sums are differentiable in feats."""
    ssum = _NeighbourSum.apply(feats, graph, direction)
    return ssum, graph.direction(direction).degrees.to(torch.float32)


def aggregate_mean(graph: VGLGraph, feats: torch.Tensor,
                   direction: TraversalDirection = G) -> torch.Tensor:
    """Mean of neighbour features: [v_pad, F] -> [v_pad, F] (sorted ordering
    of `direction`; neighbours = in-neighbours for GATHER); 0 without
    neighbours."""
    ssum, cnt = aggregate_sum_count(graph, feats, direction)
    return ssum / torch.clamp(cnt, min=1)[:, None]


def _sample_from_uniforms(dg: DeviceDirectedGraph,
                          u: torch.Tensor) -> torch.Tensor:
    """The reference's sampling formula (gnn.py:99-105) on given uniforms u
    [v_pad, k] in [0, 1): row v takes col_idx[row_start + min(int(u * deg),
    deg - 1)], or v itself without neighbours."""
    deg = dg.degrees
    start = dg.row_ptr[:dg.v_pad]
    off = torch.minimum((u * deg[:, None]).to(torch.int32),
                        torch.clamp(deg - 1, min=0)[:, None])
    idx = dg.col_idx[(start[:, None] + off).clamp(
        0, dg.col_idx.shape[0] - 1).long()]
    self_ids = torch.arange(dg.v_pad, dtype=torch.int32,
                            device=idx.device)[:, None].expand_as(idx)
    return torch.where((deg > 0)[:, None], idx, self_ids)


def sample_neighbors(graph: VGLGraph, k: int, generator: torch.Generator,
                     direction: TraversalDirection = S) -> torch.Tensor:
    """Uniform-with-replacement neighbour sample: int32 [v_pad, k] of
    `direction`'s sorted ids; vertices with no neighbours sample themselves.
    The uniforms come from `generator` (on the graph's device): the same
    seed gives the same sample on one device, not the JAX package's (its
    counter-based stream cannot be reproduced)."""
    u = torch.rand((graph.v_pad, k), generator=generator,
                   device=graph.device)
    return _sample_from_uniforms(graph.direction(direction), u)


def aggregate_sampled_mean(feats: torch.Tensor,
                           sampled: torch.Tensor) -> torch.Tensor:
    """[v_pad, F], [v_pad, k] -> mean of the sampled neighbours' features."""
    idx = sampled.clamp(0, feats.shape[0] - 1).long()
    return feats[idx].mean(dim=1)


class SageParams(torch.nn.Module):
    """The reference's SageParams: two layers, each a self weight, a
    neighbour weight and a bias."""

    def __init__(self, w_self1, w_nbr1, b1, w_self2, w_nbr2, b2):
        super().__init__()
        for name, t in (("w_self1", w_self1), ("w_nbr1", w_nbr1), ("b1", b1),
                        ("w_self2", w_self2), ("w_nbr2", w_nbr2),
                        ("b2", b2)):
            self.register_parameter(name, torch.nn.Parameter(t))


def init_sage(generator: torch.Generator, in_dim: int, hidden: int,
              out_dim: int) -> SageParams:
    """Weights normal / sqrt(fan-in) and zero biases, as the reference's,
    from `generator` on its device (not the JAX package's numbers: carry
    those across with sage_params_from_numpy)."""
    dev = generator.device

    def s(a, b):
        return torch.randn((a, b), generator=generator,
                           device=dev) / float(np.sqrt(a))
    return SageParams(s(in_dim, hidden), s(in_dim, hidden),
                      torch.zeros(hidden, device=dev),
                      s(hidden, out_dim), s(hidden, out_dim),
                      torch.zeros(out_dim, device=dev))


def sage_params_from_numpy(params: Dict[str, np.ndarray],
                           device="cuda") -> SageParams:
    """SageParams from arrays named as the reference's fields (e.g. its
    init_sage output, {k: np.asarray(v) for k, v in p._asdict().items()})."""
    return SageParams(*(torch.tensor(np.asarray(params[k]),
                                     dtype=torch.float32, device=device)
                        for k in ("w_self1", "w_nbr1", "b1", "w_self2",
                                  "w_nbr2", "b2")))


def sage_forward(params: SageParams, graph: VGLGraph, feats: torch.Tensor,
                 sampled1: Optional[torch.Tensor] = None,
                 sampled2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """2-layer GraphSAGE logits [v_pad, out]; full aggregation where a
    sample is None."""
    agg = (aggregate_mean(graph, feats) if sampled1 is None
           else aggregate_sampled_mean(feats, sampled1))
    h = torch.relu(feats @ params.w_self1 + agg @ params.w_nbr1 + params.b1)
    agg2 = (aggregate_mean(graph, h) if sampled2 is None
            else aggregate_sampled_mean(h, sampled2))
    return h @ params.w_self2 + agg2 @ params.w_nbr2 + params.b2


def sage_loss(params: SageParams, graph: VGLGraph, feats: torch.Tensor,
              labels: torch.Tensor, mask: torch.Tensor,
              sampled1: Optional[torch.Tensor] = None,
              sampled2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross-entropy over the masked vertices (the reference's
    loss_fn, gnn.py:147-152)."""
    logits = sage_forward(params, graph, feats, sampled1, sampled2)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels.long()[:, None])[:, 0]
    return torch.where(mask, nll, 0.0).sum() / torch.clamp(mask.sum(), min=1)


def make_train_step(graph: VGLGraph, optimizer: torch.optim.Optimizer):
    """Cross-entropy node-classification train step: step(params, feats,
    labels, mask, s1=None, s2=None) takes one optimizer step on params (the
    optimizer's) in place and returns the loss before it, as a 0-d
    tensor."""
    def step(params, feats, labels, mask, s1=None, s2=None):
        optimizer.zero_grad(set_to_none=True)
        loss = sage_loss(params, graph, feats, labels, mask, s1, s2)
        loss.backward()
        optimizer.step()
        return loss.detach()
    return step


def seq_aggregate_mean(ec, feats: np.ndarray) -> np.ndarray:
    """Oracle: mean of in-neighbour features, original ids, multiplicity
    kept, in float64. The reference's np.add.at over an [E, F] gather is
    one product with scipy's sparse matrix of edge counts here (parallel
    edges sum to their multiplicity), which takes seconds, not minutes, at
    RMAT-20."""
    import scipy.sparse as sp
    v = ec.vertices_count
    a = sp.csr_matrix((np.ones(ec.edges_count), (ec.dst_ids, ec.src_ids)),
                      shape=(v, v))
    acc = a @ np.asarray(feats, np.float64)
    cnt = np.bincount(ec.dst_ids, minlength=v)
    return acc / np.maximum(cnt, 1)[:, None]
