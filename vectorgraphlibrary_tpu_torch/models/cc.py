"""Connected components: Shiloach-Vishkin label propagation, the flood
hybrid and the BFS-based variant (port of vectorgraphlibrary_tpu/models/cc.py).

Capability match for the reference CC (`algorithms/cc/cc.h:18-44`,
`shiloach_vishkin.hpp:6-91` hook+jump loop; `bfs_based.hpp`). Labels live in
ORIGINAL id space (so label values are ordering-independent); each SV
iteration is two int32 min pulls (incoming + outgoing = the undirected
neighbourhood's min; two CSR pull kernel launches and four vertex routes)
and, every fourth iteration, a double pointer jump. The reference's
`lax.while_loop`s are host loops here that read one flag per iteration, with
the same state and condition, so labels and iteration counts are the same.
One departure: where the flood hybrid's flood does not close, or its tails
stay deep, the port finishes by Shiloach-Vishkin link rounds
(`_link_rounds`) and raises at a cap, where the JAX package hooks min
labels with no pointer jumps and returns whatever it holds at its cap.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import TraversalDirection
from ..graph.device import VGLGraph
from ..graph.vertices import VertexArray
from ..ops import monoid as M
from ..runtime.profiling import annotate
from . import common

O = TraversalDirection.ORIGINAL
_BIGI = torch.iinfo(torch.int32).max


def _ids_real(graph: VGLGraph):
    ids = torch.arange(graph.v_pad, dtype=torch.int32, device=graph.device)
    return ids, ids < graph.v


def _fixpoint_from_minus_one(step, labels0: torch.Tensor,
                             max_iterations: int):
    """The reference's label loop: state (labels0, -1, 0), step(labels, it)
    while it < max_iterations and any(labels != prev)."""
    labels, prev, it = labels0, torch.full_like(labels0, -1), 0
    while it < max_iterations and common.read_scalar(
            torch.any(labels != prev)):
        labels, prev, it = step(labels, it), labels, it + 1
    return labels, it


def _sv_run(graph: VGLGraph, max_iterations: int):
    v, v_pad = graph.v, graph.v_pad
    ids, real = _ids_real(graph)
    labels0 = torch.where(real, ids, v)        # ORIGINAL ids as labels

    def hook(labels):
        """min over the undirected neighbourhood, computed per direction."""
        return torch.minimum(labels,
                             common.undirected_value_pull(graph, labels, "min"))

    def jump(labels):
        return labels[labels.clamp(max=v_pad - 1).long()]

    def step(labels, it):
        new = hook(labels)
        # pointer jumps run every 4th iteration, as chain accelerators only,
        # as in the reference. A hook-only fixpoint is already correct CC
        # (labels locally minimal => constant per weak component), so
        # stopping on no-change stays sound.
        if it % 4 == 3:
            new = jump(jump(new))
        return torch.where(real, new, v)

    return _fixpoint_from_minus_one(step, labels0, max_iterations)


def vgl_shiloach_vishkin(graph: VGLGraph, max_iterations: int = 1000
                         ) -> tuple[VertexArray, int]:
    labels, iters = _sv_run(graph, max_iterations)
    return VertexArray(values=labels, direction=O), iters


# a closed flood's other components are hooked to their least label for at
# most this many iterations; tails that are still changing then are
# finished by _link_rounds
_TAIL_HOOKS = 32


def _compress(labels: torch.Tensor) -> torch.Tensor:
    """Pointer jumping to stars: labels[x] <- labels[labels[x]] until every
    vertex points at a root (a vertex that is its own label). One host read
    per jump; the depth halves with each."""
    with annotate("vgl.cc.compress"):
        while True:
            nxt = labels[labels.long()]
            if not common.read_scalar(torch.any(nxt != labels)):
                return labels
            labels = nxt


def _link_rounds(graph: VGLGraph, labels: torch.Tensor, max_rounds: int):
    """Shiloach-Vishkin rounds over the whole graph to the fixpoint.

    `labels` is a forest in ORIGINAL ids: each vertex's label is a vertex
    of its own component, and following labels ends at a root, a vertex
    that is its own label. A round compresses every tree to a star, then
    links: each root takes the least label that an edge of its star
    reaches, where that is smaller (the undirected i32 min pull, then one
    scatter of min into the roots). Links go only to smaller labels, so
    no cycle forms, and the trees merge along every edge at once: the
    rounds do not grow with the diameter. The fixpoint is a round that
    finds no smaller label across any edge; every component then holds
    one label, its least initial label. Raises RuntimeError where a link
    beyond `max_rounds` would be needed. Returns (labels, links made)."""
    rounds = 0
    while True:
        labels = _compress(labels)
        with annotate("vgl.cc.link"):
            m = common.undirected_value_pull(graph, labels, "min")
            if not common.read_scalar(torch.any(m < labels)):
                return labels, rounds
            if rounds == max_rounds:
                raise RuntimeError(
                    f"vgl_cc_hybrid: no fixpoint after {max_rounds} "
                    f"label rounds (max_iterations)")
            # a vertex whose m is not below its root's label leaves the
            # root as it is
            labels = M.get("min").scatter_at_(labels.clone(), labels, m)
        rounds += 1


def _cc_hybrid_run(graph: VGLGraph, hub: int, max_flood: int,
                   max_iterations: int):
    """Flood-hybrid CC (the reference's own BFS-based CC
    `algorithms/cc/bfs_based.hpp` is the same idea): bool or-pulls flood the
    hub's weak component (the cheapest pull: 1-byte values), freeze it at
    one label, then hook-min only the remaining components. Correct for ANY
    hub (a bad hub only costs speed) and any diameter. Returns (labels,
    flood levels, hook iterations plus link rounds).

    Where the flood does not close within max_flood levels, its reach is a
    strict part of the hub's component and nothing is frozen: Shiloach-
    Vishkin rounds (_link_rounds) label the whole graph from the ORIGINAL
    ids. Tails still changing after _TAIL_HOOKS hook iterations are
    finished the same way. Both give each component its least id, the
    labels of the JAX package's hook-min wherever that reaches its
    fixpoint; the JAX package instead hooks with no pointer jumps up to
    max_iterations and returns what it has there. Here a cap that is hit
    raises RuntimeError."""
    v = graph.v
    ids, real = _ids_real(graph)

    def und_or(reach_o):
        return common.undirected_value_pull(graph, reach_o, "or")

    reach = frontier = ids == hub
    flood_lv, live = 0, True
    while flood_lv < max_flood and (
            live := common.read_scalar(torch.any(frontier))):
        with annotate("vgl.cc.flood"):
            frontier = und_or(frontier) & ~reach & real
            reach = reach | frontier
        flood_lv += 1
    if flood_lv == max_flood:       # did the last level close the flood?
        live = common.read_scalar(torch.any(frontier))
    if live:
        labels, rounds = _link_rounds(graph, torch.where(real, ids, v),
                                      max_iterations)
        return labels, flood_lv, rounds

    labels0 = torch.where(reach, hub, ids)
    labels0 = torch.where(real, labels0, v)

    def step(labels, it):
        with annotate("vgl.cc.hook"):
            m = common.undirected_value_pull(graph, labels, "min")
            new = torch.minimum(labels, torch.where(real, m, _BIGI))
            # no pointer jumps: the flood covered the giant component and
            # the tails are mostly shallow
            new = torch.where(reach, hub, new)      # frozen hub component
            return torch.where(real, new, v)

    budget = min(_TAIL_HOOKS, max_iterations)
    labels, prev, hooks = labels0, torch.full_like(labels0, -1), 0
    while common.read_scalar(torch.any(labels != prev)):
        if hooks == budget:
            labels, rounds = _link_rounds(graph, labels,
                                          max_iterations - hooks)
            return labels, flood_lv, hooks + rounds
        labels, prev, hooks = step(labels, hooks), labels, hooks + 1
    return labels, flood_lv, hooks


def vgl_cc_hybrid(graph: VGLGraph, hub: Optional[int] = None,
                  max_flood: int = 1000, max_iterations: int = 1000
                  ) -> tuple[VertexArray, int]:
    """Flood-hybrid CC; hub defaults to the max-out-degree vertex (the first
    of them in ORIGINAL ordering). Returns (labels, hook iterations plus
    link rounds); max_iterations caps those together and raises
    RuntimeError when reached short of the fixpoint (_cc_hybrid_run)."""
    with annotate("vgl.cc"):
        if hub is None:
            with annotate("vgl.cc.hub"):
                outdeg_o = common.outdegrees_in(graph, O)
                hub = common.read_scalar(torch.argmax(outdeg_o[:graph.v]))
        labels, _, iters = _cc_hybrid_run(graph, int(hub), max_flood,
                                          max_iterations)
    return VertexArray(values=labels, direction=O), iters


def vgl_cc_hybrid_multi(graph: VGLGraph, hubs) -> VertexArray:
    """k flood-hybrid CC runs from k hubs, one after another: labels
    [k, v_pad] in ORIGINAL ordering."""
    return VertexArray(values=torch.stack([
        _cc_hybrid_run(graph, int(h), 1000, 1000)[0] for h in hubs]),
        direction=O)


def vgl_bfs_based(graph: VGLGraph, max_components: int = 1_000_000
                  ) -> VertexArray:
    """BFS-based CC (reference cc/bfs_based.hpp): repeatedly BFS-flood the
    first unlabeled vertex over the undirected graph. Efficient when
    components are few; isolated vertices are labeled in one vectorized shot
    first."""
    v, v_pad = graph.v, graph.v_pad
    ids, real = _ids_real(graph)
    # ORIGINAL-space degrees (und: out+in)
    und_deg = common.outdegrees_in(graph, O) + common.indegrees_in(graph, O)
    labels = torch.where(real & (und_deg == 0), ids, -1)
    labels = torch.where(real, labels, v)

    def flood_step(reach_o):
        """One undirected BFS-flood expansion in ORIGINAL space."""
        return (reach_o | common.undirected_value_pull(graph, reach_o, "or")) \
            & real

    comp = 0
    while comp < max_components:
        seed = int(torch.argmax((labels == -1).to(torch.int32)))
        if int(labels[seed]) != -1:
            break
        reach = torch.zeros(v_pad, dtype=torch.bool, device=graph.device)
        reach[seed] = True
        size = 1
        while True:
            reach2 = flood_step(reach)
            new_size = int(torch.sum(reach2))
            if new_size == size:
                break
            reach, size = reach2, new_size
        labels = torch.where(reach2, seed, labels)
        comp += 1
    return VertexArray(values=labels, direction=O)


def seq_cc(ec) -> np.ndarray:
    """Oracle: weakly connected components via SciPy."""
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csg
    v = ec.vertices_count
    a = sp.csr_matrix((np.ones(ec.edges_count, np.int8),
                       (ec.src_ids, ec.dst_ids)), shape=(v, v))
    _, labels = csg.connected_components(a, directed=True, connection="weak")
    return labels.astype(np.int32)
