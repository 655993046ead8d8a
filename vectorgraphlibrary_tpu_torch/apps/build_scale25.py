"""Build and persist the large synthetic tier as the port's slim shards (the
port's counterpart of apps/build_scale25.py): RMAT-25 at degree 32 (the
reference's `syn_rmat_25_32`, |E| = 1,073,741,824), in 8 shards by a
multiplicative hash of the destination, with the generator's per-edge f32
weights stored in route-slot order.

    VGL_S25_SCALE=25 VGL_S25_DEGREE=32 VGL_S25_SHARDS=8 VGL_S25_WORKERS=4 \\
    VGL_S25_GEN=rmat_fast python -m vectorgraphlibrary_tpu_torch.apps.build_scale25

Environment (the JAX script's): VGL_S25_SCALE (25), VGL_S25_DEGREE (32),
VGL_S25_SHARDS (8), VGL_S25_WORKERS (2: shards built at once),
VGL_S25_CACHE (<repo>/.cache, gitignored), and VGL_S25_GEN, the generator:
`rmat` (the default, as the JAX script's, so that both builders make the
same graph) or `rmat_fast` (io/generation.rmat_fast, a different graph in
chunks on one process per core: what scale 25 needs). The files go to
`{cache}/rmat{S}_{D}_slimw.*`:

- `.shard{s}.npz`: the port's slim shard, as persistence.
  save_sharded_graph writes a shard_build.slim_value_pull shard: each
  direction's CSR, the tiles' metadata, the three vertex routes (Beneš
  networks) and no advance route, so no route of 2^28 slots is routed;
- `.weights{s}.npy`: the shard's incoming weights in route-slot order
  (persistence.save_sharded_weights' layout: slot in_route_slots[k] holds
  the weight of incoming CSR slot k, 0 where no edge lies);
- `.prconsts.npz`: PageRank's constants (parallel/sharded.pr_consts),
  made while the edges are in memory;
- `.meta.json`: n_shards, v, v_pad, e, edges_per_shard, "partition":
  "dst-hash", the generator and the route's slot count.

persistence.load_sharded_graph and streaming.load_streamed(weights=True)
read them; the JAX package does not (it pulls through the advance route
that the port's slim shard drops). The tier's apps are
apps/bench_scale25.py (streamed) and apps/bench_s22w_resident.py
(resident).

Host only: NumPy, the port's host code and its native router (native.py).
The script never creates a CUDA context, so its fork pool (one process
per shard, maxtasksperchild=1, each shard's edges shared copy-on-write) is
safe, and rmat_fast's pool too. Prints the host's cores and memory first
and one JSON line last: seconds to generate and to build, bytes on disk,
edges per shard and the workers' peak resident memory.

build() is the scale tiers' one builder: apps/build_scale24.py runs it on
unweighted rmat(seed=42) in dst % S shards, their count chosen from the
graph.
"""
from __future__ import annotations

import json
import multiprocessing as mp
import os
import resource
import sys
import time

import numpy as np

from .scale_tier import log, settings

SEED = 42


def shard_of(dst: np.ndarray, n_shards: int) -> np.ndarray:
    """Multiplicative-hash destination partition (apps/build_scale25.py's
    shard_of): the top 3 bits of dst * 0x9E3779B97F4A7C15 modulo 2^64,
    modulo n_shards. dst % S puts the RMAT hubs' low ids together (shard 0
    of 4 holds 58 % of RMAT-20's edges under it)."""
    h = (dst.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)) & np.uint64(
        0xFFFFFFFFFFFFFFFF)
    return ((h >> np.uint64(61)) % np.uint64(n_shards)).astype(np.int32)


def host_summary() -> dict:
    """The host's cores and memory (GiB), from os and /proc/meminfo."""
    mem = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, val = line.split(":", 1)
            if key in ("MemTotal", "MemAvailable"):
                mem[key] = round(int(val.split()[0]) / 2**20, 1)
    return {"nproc": os.cpu_count(), "mem_total_gib": mem.get("MemTotal"),
            "mem_available_gib": mem.get("MemAvailable")}


# the workers' shared state, set before the fork and read copy-on-write
_G: dict = {}


def build_shard(s: int) -> dict:
    """Shard s: its slim file and, where the tier stores weights, its
    route-slot weights, written here."""
    import torch
    from ..graph import persistence
    from ..parallel.shard_build import build_shard_edges
    from ..parallel.sharded import route_slot_count
    t0 = time.time()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _G["workers"]))
    src, dst, w = _G["parts"][s]
    prefix = _G["prefix"]
    log(f"shard {s}: {len(src):,} edges")
    g, hosts = build_shard_edges(src, dst, _G["v"], _G["plan"],
                                 device="cpu", slim=True)
    e = len(src)
    route_n = route_slot_count(g)
    # incoming CSR slot -> shard edge
    perm = None if w is None else hosts[1].edge_perm[:e]
    del hosts                          # the host CSRs' tiles, before saving
    if w is not None:
        slots = np.zeros(route_n, np.float32)
        slots[g.in_route_slots.numpy()] = w[perm]
        del perm
        persistence.save_shard_weights(slots, prefix, s)
        del slots
    persistence.save_graph_to_binary_file(g, f"{prefix}.shard{s}.npz",
                                          compressed=False)
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    log(f"shard {s}: done in {time.time() - t0:.1f} s, peak RSS "
        f"{peak:.2f} GiB")
    return {"s": s, "edges": e, "route_n": int(route_n),
            "seconds": time.time() - t0, "peak_rss_gib": peak}


def _generate(cfg: dict):
    from ..io import generation
    if cfg["generator"] == "rmat_fast":
        return generation.rmat_fast(cfg["scale"], cfg["degree"], seed=SEED,
                                    weighted=cfg["weighted"],
                                    workers=os.cpu_count() or 1)
    return generation.rmat(cfg["scale"], cfg["degree"], seed=SEED,
                           weighted=cfg["weighted"])


PARTITIONS = {"dst-hash": shard_of,
              "dst-mod": lambda dst, n_shards: dst % n_shards}


def _build_shards(shards: list, workers: int) -> list:
    """build_shard over `shards` in a fork pool of `workers` processes."""
    _G["workers"] = workers
    with mp.get_context("fork").Pool(workers, maxtasksperchild=1) as pool:
        return pool.map(build_shard, shards, chunksize=1)


def build(cfg: dict, shard_count=None) -> dict:
    """Generate, partition and write the tier (module doc); -> the summary
    that main prints. cfg (scale_tier.settings, settings24): the graph
    (scale, degree, generator, weighted: whether the generator's weights
    are stored), the partition (PARTITIONS: "dst-hash" or "dst-mod"), the
    shard count (shards, or shard_count(ec) where shards is None), the
    workers and where the files go. A shard that holds more than half the
    edges (dst % 2 leaves RMAT's shard 0 about three quarters) is built
    first with no other beside it: a worker's memory grows with its
    shard's edges."""
    from .. import native
    from ..parallel.shard_build import plan_parts
    from ..parallel.sharded import pr_consts
    prefix = cfg["prefix"]
    os.makedirs(cfg["cache"], exist_ok=True)
    t0 = time.time()
    log(f"generating RMAT scale={cfg['scale']} degree={cfg['degree']} "
        f"({'weighted' if cfg['weighted'] else 'unweighted'}, "
        f"{cfg['generator']}) ...")
    ec = _generate(cfg)
    v, e = ec.vertices_count, ec.edges_count
    gen_s = time.time() - t0
    log(f"generated |V|={v:,} |E|={e:,} ({gen_s:.1f} s)")
    rev, dmask = pr_consts(ec)
    np.savez(f"{prefix}.prconsts.npz", rev=rev, dmask=dmask)
    del rev, dmask
    n_shards = cfg["shards"] if cfg["shards"] is not None else shard_count(ec)
    sid = PARTITIONS[cfg["partition"]](ec.dst_ids, n_shards)
    parts = []
    for s in range(n_shards):
        m = sid == s
        parts.append((ec.src_ids[m], ec.dst_ids[m],
                      ec.weights[m] if cfg["weighted"] else None))
        log(f"  shard {s}: {len(parts[-1][0]):,} edges")
    del sid, ec, m
    plan = plan_parts([(p[0], p[1]) for p in parts], v)
    log(f"partitioned and planned ({time.time() - t0:.1f} s): v_pad=2^"
        f"{plan.v_pad.bit_length() - 1} e_pad={plan.e_pad:,}")
    _G.update(parts=parts, plan=plan, v=v, prefix=prefix)
    native.load_router()               # build the router before forking
    t1 = time.time()
    big = max(range(n_shards), key=lambda s: len(parts[s][0]))
    rest = list(range(n_shards))
    infos = []
    if 2 * len(parts[big][0]) > e:
        rest.remove(big)
        infos += _build_shards([big], 1)
    if rest:
        infos += _build_shards(rest, min(cfg["workers"], len(rest)))
    build_s = time.time() - t1
    infos.sort(key=lambda i: i["s"])
    meta = {"n_shards": n_shards, "v": v, "v_pad": int(plan.v_pad),
            "e": e, "edges_per_shard": [i["edges"] for i in infos],
            "weighted": cfg["weighted"], "partition": cfg["partition"],
            "generator": cfg["generator"], "seed": SEED,
            "route_n": infos[0]["route_n"]}
    with open(f"{prefix}.meta.json", "w") as f:
        json.dump(meta, f)
    on_disk = sum(os.path.getsize(os.path.join(cfg["cache"], name))
                  for name in os.listdir(cfg["cache"])
                  if name.startswith(os.path.basename(prefix) + "."))
    return {"built": prefix, "scale": cfg["scale"], "degree": cfg["degree"],
            "shards": n_shards, "workers": cfg["workers"],
            "generator": cfg["generator"], "partition": cfg["partition"],
            "v": v, "e": e, "gen_s": gen_s, "build_s": build_s,
            "total_s": time.time() - t0, "bytes_on_disk": on_disk,
            "edges_per_shard": meta["edges_per_shard"],
            "shard_s": [i["seconds"] for i in infos],
            "shard_peak_rss_gib": [i["peak_rss_gib"] for i in infos],
            "worker_peak_rss_gib": max(i["peak_rss_gib"] for i in infos),
            **host_summary()}


def main(cfg=None, shard_count=None) -> int:
    """Build the tier of cfg (scale_tier.settings by default) unless its
    meta file exists; print the summary."""
    cfg = settings() if cfg is None else cfg
    log(f"host: {json.dumps(host_summary())}")
    if os.path.exists(f"{cfg['prefix']}.meta.json"):
        log(f"already built: {cfg['prefix']}.meta.json")
        return 0
    print(json.dumps(build(cfg, shard_count)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
