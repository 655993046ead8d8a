"""Generate `lj-replica`, a soc-LiveJournal1-scale Chung-Lu graph (the
port's counterpart of apps/make_lj_replica.py, the same file byte for
byte).

    python -m vectorgraphlibrary_tpu_torch.apps.make_lj_replica

A directed Chung-Lu graph at soc-LiveJournal1's published size (|V| =
4,847,571, |E| = 68,993,773; KONECT): expected degrees w_i ~ (i + 1)^(-1 /
(gamma - 1)) with gamma = 2.65, scaled to a mean of |E| / |V|, capped at
20,000 and scaled again; each edge's source and destination drawn
independently in proportion to w by inverse-CDF sampling (float64
uniforms searched in the float64 normalised cumulative sum) from
np.random.default_rng(71), every source first, then every destination.
Repeated edges and self-loops stay, as the JAX script keeps them.

Writes {io.corpus.graph_dir()}/lj-replica.el_container ($VGL_GRAPH_DIR or
<repo>/.graphs/, both gitignored), which apps/bench_lj.py and the real tier
of apps/run_tests.py pick up by name; a file already there is kept. Prints
a log line, then one JSON line: the seconds, the file's bytes and sha256,
the largest out-degree and the mean. `replica(v, e, max_deg)` builds the
same graph, or a smaller one of the same construction, in memory.
"""
from __future__ import annotations

import hashlib
import json
import os
import sys
import time

import numpy as np

from ..io import corpus
from ..io.edges_container import EdgesContainer
from .scale_tier import log

NAME = "lj-replica"
V = 4_847_571
E = 68_993_773
GAMMA = 2.65
MAX_DEG = 20_000
SEED = 71


def weights(v: int = V, e: int = E, gamma: float = GAMMA,
            max_deg: float = MAX_DEG) -> np.ndarray:
    """The expected degrees: a power law of exponent -1 / (gamma - 1)
    over the ranks 1..v, scaled to sum to e, clipped at max_deg and scaled
    to sum to e again."""
    alpha = 1.0 / (gamma - 1.0)
    i = np.arange(v, dtype=np.float64)
    w = (i + 1.0) ** (-alpha)
    w *= e / w.sum()
    w = np.minimum(w, max_deg)
    w *= e / w.sum()
    return w


def replica(v: int = V, e: int = E,
            max_deg: float = MAX_DEG) -> EdgesContainer:
    """The Chung-Lu graph (module doc) of v vertices and e edges, without
    weights, from GAMMA and SEED; at the defaults, lj-replica itself."""
    cdf = np.cumsum(weights(v, e, GAMMA, max_deg))
    cdf /= cdf[-1]
    rng = np.random.default_rng(SEED)
    src = np.searchsorted(cdf, rng.random(e)).astype(np.int32)
    dst = np.searchsorted(cdf, rng.random(e)).astype(np.int32)
    return EdgesContainer(src, dst, v)


def path() -> str:
    return os.path.join(corpus.graph_dir(), f"{NAME}.el_container")


def sha256(file: str) -> str:
    h = hashlib.sha256()
    with open(file, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def main(argv=None) -> int:
    del argv
    out = path()
    if os.path.exists(out):
        log(f"already built: {out}")
        return 0
    t0 = time.perf_counter()
    ec = replica(V, E, MAX_DEG)
    gen_s = time.perf_counter() - t0
    ec.save_to_binary_file(out)
    deg = np.bincount(ec.src_ids, minlength=V)
    log(f"done in {time.perf_counter() - t0:.1f} s: |V|={V:,} |E|={E:,} "
        f"max_outdeg={deg.max():,} mean={deg.mean():.1f} -> {out}")
    print(json.dumps(dict(graph=NAME, v=V, e=E, gen_s=gen_s,
                          seconds=time.perf_counter() - t0,
                          bytes=os.path.getsize(out), sha256=sha256(out),
                          max_outdeg=int(deg.max()),
                          mean_outdeg=float(deg.mean()))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
