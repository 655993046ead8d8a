"""Process groups for multi-rank execution (port of
vectorgraphlibrary_tpu/parallel/mesh.py).

The reference lays its devices out as a 2-D `jax.sharding.Mesh` with axes

- ``"e"`` (edge-parallel): edges are partitioned across ranks; per-vertex
  partial results merge with an all-reduce over this axis;
- ``"v"`` (vertex-partition): per-vertex state is range-partitioned; full
  views come from an all-gather over this axis.

Here each rank is one process of a `torch.distributed` group, and a mesh is
a small record: the rank's coordinates on the (e, v) grid and the process
group of each axis. A `torch.distributed.device_mesh.DeviceMesh` is not
used: it binds each rank to the device of its index (several ranks that
share one card, as on a one-card host, do not fit it), and the way it
builds its groups differs between the torch versions the port runs on. Two
`new_group` calls per grid line work the same for gloo and NCCL, on the
CPU and on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

def init_distributed(device="cuda", init_method: str = "env://",
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     backend: Optional[str] = None) -> torch.device:
    """Join the default process group (the reference's
    jax.distributed.initialize, the C++ reference's MPI_Init). By default
    from torchrun's variables (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT);
    or from an explicit `init_method` such as ``file:///path`` with `rank`
    and `world_size`. The backend follows the device (NCCL for cuda, gloo
    for cpu) unless `backend` names one: several ranks that share one card
    run gloo on CUDA tensors. Returns the device (a card's with its
    index: torch.cuda.set_device takes no other)."""
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    kw = {}
    if rank is not None:
        kw.update(rank=rank, world_size=world_size)
    dist.init_process_group(backend, init_method=init_method, **kw)
    return device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on the (e, v) grid: rank r sits at
    (r // n_vertex, r % n_vertex), as np.reshape(devices, (n_e, n_v)) lays
    the reference's devices out. e_group joins the ranks of this rank's
    column (same v index), v_group those of its row (same e index)."""

    n_edge: int
    n_vertex: int
    e_index: int
    v_index: int
    e_group: object
    v_group: object
    device: torch.device


def _line_groups(lines: list, world: int) -> list:
    """One process group per list of ranks; every rank must call new_group
    for every line, member or not, in the same order."""
    return [dist.group.WORLD if len(ranks) == world else dist.new_group(ranks)
            for ranks in lines]


def make_mesh(n_edge: Optional[int] = None, n_vertex: int = 1,
              device="cuda") -> Mesh:
    """The (n_edge, n_vertex) grid over the default group's ranks."""
    world = dist.get_world_size()
    if n_edge is None:
        n_edge = world // n_vertex
    if n_edge * n_vertex != world:
        raise ValueError(f"a {n_edge} x {n_vertex} mesh over {world} ranks")
    rank = dist.get_rank()
    e_index, v_index = divmod(rank, n_vertex)
    columns = _line_groups([[i * n_vertex + j for i in range(n_edge)]
                            for j in range(n_vertex)], world)
    rows = _line_groups([[i * n_vertex + j for j in range(n_vertex)]
                         for i in range(n_edge)], world)
    return Mesh(n_edge=n_edge, n_vertex=n_vertex, e_index=e_index,
                v_index=v_index, e_group=columns[v_index],
                v_group=rows[e_index], device=torch.device(device))


def default_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """The reference's factorization: 2 vertex partitions when the rank
    count is even, else 1. n_devices must equal the world size."""
    n = n_devices or dist.get_world_size()
    n_v = 2 if n % 2 == 0 and n >= 2 else 1
    return make_mesh(n // n_v, n_v, device)


def replicated(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank holds all of x."""
    del mesh
    return x


def _part(x: torch.Tensor, n: int, i: int) -> torch.Tensor:
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split into {n} parts")
    step = x.shape[0] // n
    return x[i * step:(i + 1) * step]


def edge_sharded(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's equal part of x's leading axis along the edge axis."""
    return _part(x, mesh.n_edge, mesh.e_index)


def vertex_sharded(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's equal part of x's leading axis along the vertex axis."""
    return _part(x, mesh.n_vertex, mesh.v_index)
