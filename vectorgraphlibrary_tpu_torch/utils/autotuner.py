"""Storage-format chooser behind `-format auto` (port of the chooser of
vectorgraphlibrary_tpu/utils/autotuner.py).

A per-graph feature vector (degree-distribution moments, skew, density) and
a k-nearest-neighbour vote over benchmarked (features -> best config)
samples pick the graph format and the huge-row tile parameters; without
samples a cold-start rule picks them. All of it is numpy, and it picks
exactly what the JAX package picks for the same graph.

The bundled samples (data/autotuner_samples.json, a copy of the JAX
package's) were measured on a TPU: each names the configuration under which
PageRank ran fastest there. On the card the choice changes less. Every
format runs the same CSR kernels (ops/advance.py), so what differs is only
`huge_degree_threshold` and `huge_row_chunk` (which rows the tiles cut into
chunks: the tile pass of advance_cells reads them) and whether the advance
route is built (TILE_CSR only; no hot path of the port reads it). Sampling
the card itself (the reference's collect_samples and
generate_learning_data, which time the device) is not ported.
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..config import GraphFormat, VGLConfig
from ..io.edges_container import EdgesContainer


def extract_features(ec: EdgesContainer) -> np.ndarray:
    """Per-graph feature vector (reference prepare_nn_input.h analog)."""
    v, e = ec.vertices_count, ec.edges_count
    outdeg = np.bincount(ec.src_ids, minlength=v).astype(np.float64)
    indeg = np.bincount(ec.dst_ids, minlength=v).astype(np.float64)
    srt = np.sort(outdeg)[::-1]
    top1 = srt[: max(v // 100, 1)].sum() / max(e, 1)     # hub edge share
    gini_proxy = (srt * np.arange(1, v + 1)).sum() / max(srt.sum() * v, 1)
    return np.array([
        np.log2(max(v, 2)),
        np.log2(max(e, 2)),
        e / max(v, 1),                                   # avg degree
        outdeg.std() / max(outdeg.mean(), 1e-9),         # degree CV (skew)
        indeg.std() / max(indeg.mean(), 1e-9),
        top1,
        gini_proxy,
        (outdeg == 0).mean(),
        (indeg == 0).mean(),
    ])


class FormatAutotuner:
    """k-NN over benchmarked (features -> best config) samples."""

    def __init__(self, samples=None):
        self.samples = samples or []     # list of (features list, config dict)

    def add_sample(self, ec: EdgesContainer, best: dict) -> None:
        self.samples.append((extract_features(ec).tolist(), best))

    def choose(self, ec: EdgesContainer, k: int = 3) -> dict:
        if not self.samples:
            return self._heuristic(ec)
        f = extract_features(ec)
        feats = np.array([s[0] for s in self.samples])
        scale = feats.std(axis=0) + 1e-9
        d = np.linalg.norm((feats - f) / scale, axis=1)
        votes = [self.samples[i][1] for i in np.argsort(d)[:k]]
        keys = {json.dumps(vv, sort_keys=True) for vv in votes}
        best = max(keys, key=lambda kk: sum(
            json.dumps(vv, sort_keys=True) == kk for vv in votes))
        return json.loads(best)

    @staticmethod
    def _heuristic(ec: EdgesContainer) -> dict:
        """Cold-start rule: power-law graphs take a low huge threshold,
        near-uniform degree graphs a higher one (fewer chunked rows)."""
        f = extract_features(ec)
        skew = f[3]
        return {
            "graph_format": GraphFormat.TILE_CSR.value,
            "huge_degree_threshold": 256 if skew > 1.5 else 1024,
            "huge_row_chunk": 512,
        }

    def apply(self, ec: EdgesContainer, cfg: VGLConfig) -> VGLConfig:
        best = self.choose(ec)
        return cfg.replace(
            graph_format=GraphFormat.parse(best["graph_format"]),
            huge_degree_threshold=best["huge_degree_threshold"],
            huge_row_chunk=best["huge_row_chunk"])

    def save(self, path: str) -> None:
        with open(path, "w") as fp:
            json.dump(self.samples, fp)

    @staticmethod
    def load(path: str) -> "FormatAutotuner":
        with open(path) as fp:
            return FormatAutotuner(json.load(fp))


BUNDLED_SAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "autotuner_samples.json")


def default_tuner() -> FormatAutotuner:
    """Tuner over the bundled samples (the cold-start rule when the file is
    absent)."""
    if os.path.exists(BUNDLED_SAMPLES):
        return FormatAutotuner.load(BUNDLED_SAMPLES)
    return FormatAutotuner()
