"""Build and persist the scale-24 tier as the port's slim shards (the port's
counterpart of apps/build_scale24.py): RMAT-24 at degree 16 (|E| =
268,435,456; the reference's "twitter-scale RMAT-24, 1 host
edge-partitioned" configuration, BASELINE.md), unweighted, in shards by
destination modulo S, the partition of parallel/shard_build.import_sharded.

    python -m vectorgraphlibrary_tpu_torch.apps.build_scale24

Environment (the JAX script's): VGL_S24_SCALE (24), VGL_S24_DEGREE (16),
and VGL_S24_CACHE (<repo>/.cache, gitignored). The shard count follows the
JAX script's rule: from 2, doubled until
parallel/shard_build.estimated_shard_slots is at most 2^28 or the count
reaches 16. The files go to `{cache}/rmat{S}_{D}_slim.*`:

- `.shard{s}.npz`: the port's slim shard (parallel/shard_build.
  slim_value_pull: each direction's CSR, the tiles' metadata, the three
  vertex routes, in_route_slots; no advance route);
- `.prconsts.npz`: PageRank's constants (parallel/sharded.pr_consts),
  made while the edges are in memory;
- `.meta.json`: n_shards, v, v_pad, e, edges_per_shard, "partition":
  "dst-mod", the generator and the route's slot count.

apps/bench_scale24.py reads them (persistence.load_sharded_graph reads the
JAX script's artifact too, its CSRs rebuilt from its advance route).

The work is apps/build_scale25.build's: host only, no CUDA context, one
forked process per shard. dst % 2 leaves RMAT's shard 0 about three
quarters of the edges, so that shard is built with no other beside it.
Prints the host's cores and memory first and one JSON line last: the
shard count, seconds to generate and to build, bytes on disk, edges per
shard and each worker's peak resident memory.
"""
from __future__ import annotations

import sys

from . import build_scale25
from .scale_tier import log, settings24

MAX_ROUTE_SLOTS = 1 << 28     # the JAX script's bound on a shard's route
MAX_SHARDS = 16


def shard_count(ec) -> int:
    """The JAX script's rule (apps/build_scale24.py:52-59): shards doubled
    from 2 until the largest shard's route fits MAX_ROUTE_SLOTS or the
    count reaches MAX_SHARDS."""
    from ..parallel.shard_build import estimated_shard_slots
    n_shards = 2
    while True:
        worst = estimated_shard_slots(ec, n_shards)
        log(f"n_shards={n_shards}: worst per-shard route n=2^"
            f"{worst.bit_length() - 1}")
        if worst <= MAX_ROUTE_SLOTS or n_shards >= MAX_SHARDS:
            return n_shards
        n_shards *= 2


def main() -> int:
    return build_scale25.main(settings24(), shard_count)


if __name__ == "__main__":
    sys.exit(main())
