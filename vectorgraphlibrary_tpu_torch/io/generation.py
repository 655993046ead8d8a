"""Synthetic graph generators: R-MAT and uniform-random.

Copied from vectorgraphlibrary_tpu/io/generation.py (NumPy only), so one seed
gives the same graph in both packages. Capability match for the reference
``GraphGenerationAPI`` (`vgl_runtime/graph_generation/graph_generation.h:28-57`):
`random_uniform` (graph_generation.hpp:5-48) and `R_MAT` recursive-quadrant
sampling (graph_generation.hpp:94-120), vectorized: all edges' quadrant
decisions for one recursion level are drawn as one batched array.
`rmat_fast` makes the billion-edge tier's graphs in chunks on a fork pool.
"""
from __future__ import annotations

import numpy as np

from .edges_container import EdgesContainer

# Standard graph500 R-MAT parameters (reference uses a=57,b=19,c=19,d=5 percent).
RMAT_A, RMAT_B, RMAT_C = 0.57, 0.19, 0.19


def random_uniform(scale: int, avg_degree: int, seed: int = 42,
                   directed: bool = True, weighted: bool = True) -> EdgesContainer:
    v = 1 << scale
    e = v * avg_degree
    rng = np.random.default_rng(seed)
    src = rng.integers(0, v, e, dtype=np.int64).astype(np.int32)
    dst = rng.integers(0, v, e, dtype=np.int64).astype(np.int32)
    ec = EdgesContainer(src, dst, v)
    if weighted:
        ec = ec.with_random_weights(seed + 1)
    return ec


def rmat(scale: int, avg_degree: int, seed: int = 42,
         a: float = RMAT_A, b: float = RMAT_B, c: float = RMAT_C,
         weighted: bool = True) -> EdgesContainer:
    """Vectorized R-MAT: one uniform draw per (edge, level), quadrant chosen by
    cumulative a/b/c/d thresholds — equivalent to the reference's per-edge loop
    (graph_generation.hpp:94-120) but batched across all edges."""
    v = 1 << scale
    e = v * avg_degree
    rng = np.random.default_rng(seed)
    src = np.zeros(e, dtype=np.int64)
    dst = np.zeros(e, dtype=np.int64)
    ab, abc = a + b, a + b + c
    for level in range(scale):
        u = rng.random(e)
        src_bit = (u >= ab).astype(np.int64)              # quadrants c,d set src bit
        dst_bit = ((u >= a) & (u < ab) | (u >= abc)).astype(np.int64)  # b or d
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    ec = EdgesContainer(src.astype(np.int32), dst.astype(np.int32), v)
    if weighted:
        ec = ec.with_random_weights(seed + 1)
    return ec


def generate(kind: str, scale: int, avg_degree: int, seed: int = 42,
             weighted: bool = True) -> EdgesContainer:
    if kind in ("rmat", "RMAT"):
        return rmat(scale, avg_degree, seed, weighted=weighted)
    if kind in ("ru", "random_uniform"):
        return random_uniform(scale, avg_degree, seed, weighted=weighted)
    raise ValueError(f"unknown synthetic graph type {kind!r}")


def rmat_fast(scale: int, avg_degree: int, seed: int = 42,
              a: float = RMAT_A, b: float = RMAT_B, c: float = RMAT_C,
              weighted: bool = True, chunk: int = 1 << 27,
              workers: int = 2) -> EdgesContainer:
    """Billion-edge R-MAT (a copy of the JAX package's rmat_fast, array for
    array the same graph): the same recursive-quadrant model as `rmat`, with
    float32 uniform draws (half the generator's traffic), int32 src/dst
    arithmetic from the start (valid for scale <= 30), chunks of `chunk`
    edges to bound peak RAM, and a fork pool of `workers` processes. Chunk
    ci draws from SeedSequence([seed, ci]) whichever worker runs it, so the
    graph depends on (seed, chunk) and not on `workers`; it is a DIFFERENT
    graph than rmat(seed). Weights: uniform [1, 100) f32 from seed + 1,
    drawn chunk by chunk.

    The pool forks, so the chunks' arguments reach the workers through a
    module global. A process that has created a CUDA context must not
    fork: this raises there, and a caller on the card runs the generator
    in a process of its own (apps/build_scale25.py)."""
    import multiprocessing as mp
    import sys
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        raise RuntimeError("rmat_fast forks its workers, and this process "
                           "has a CUDA context: run it in a process of its "
                           "own")
    v = 1 << scale
    e = v * avg_degree
    n_chunks = -(-e // chunk)
    ab, abc = a + b, a + b + c

    global _RMAT_FAST_ARGS
    _RMAT_FAST_ARGS = (scale, chunk, e, seed, a, ab, abc)

    ctx = mp.get_context("fork")
    with ctx.Pool(workers) as pool:
        parts = pool.map(_rmat_fast_chunk, range(n_chunks), chunksize=1)
    src = np.concatenate([p[0] for p in parts])
    dst = np.concatenate([p[1] for p in parts])
    del parts
    ec = EdgesContainer(src, dst, v)
    if weighted:
        rng = np.random.default_rng(seed + 1)
        w = np.empty(e, np.float32)
        for lo in range(0, e, chunk):
            hi = min(lo + chunk, e)
            w[lo:hi] = rng.uniform(1.0, 100.0, hi - lo).astype(np.float32)
        ec = EdgesContainer(src, dst, v, w)
    return ec


# rmat_fast's arguments for its forked workers (set before the fork)
_RMAT_FAST_ARGS = None


def _rmat_fast_chunk(ci: int):
    """Edges [ci * chunk, ...) of rmat_fast: (src, dst) int32."""
    scale, chunk, e, seed, a, ab, abc = _RMAT_FAST_ARGS
    lo = ci * chunk
    n = min(chunk, e - lo)
    rng = np.random.default_rng(np.random.SeedSequence([seed, ci]))
    src = np.zeros(n, dtype=np.int32)
    dst = np.zeros(n, dtype=np.int32)
    for _ in range(scale):
        u = rng.random(n, dtype=np.float32)
        src_bit = (u >= ab).astype(np.int32)
        dst_bit = ((u >= a) & (u < ab) | (u >= abc)).astype(np.int32)
        np.left_shift(src, 1, out=src)
        np.left_shift(dst, 1, out=dst)
        np.bitwise_or(src, src_bit, out=src)
        np.bitwise_or(dst, dst_bit, out=dst)
    return src, dst
