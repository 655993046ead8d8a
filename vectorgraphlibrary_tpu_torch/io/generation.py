"""Synthetic graph generators: R-MAT and uniform-random.

Copied from vectorgraphlibrary_tpu/io/generation.py (NumPy only), so one seed
gives the same graph in both packages. Capability match for the reference
``GraphGenerationAPI`` (`vgl_runtime/graph_generation/graph_generation.h:28-57`):
`random_uniform` (graph_generation.hpp:5-48) and `R_MAT` recursive-quadrant
sampling (graph_generation.hpp:94-120), vectorized: all edges' quadrant
decisions for one recursion level are drawn as one batched array.
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
