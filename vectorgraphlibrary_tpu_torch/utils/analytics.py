"""Graph analytics (port of vectorgraphlibrary_tpu/utils/analytics.py;
reference `vgl_runtime/graph_analytics/graph_analytics.h:3-16`):
degree-distribution histograms, memory-consumption estimates, component
statistics. All numpy.

`estimate_memory_consumption` reckons the port's layout, which differs from
the JAX package's in its routes: the port keeps each route as gather
indices (4 B per slot, forward and inverse) with one flag byte per slot and
direction on the advance route, where the JAX package keeps Beneš exchange
words. The COO, both CSRs and the tile copies are reckoned as there.
"""
from __future__ import annotations

import numpy as np

from ..config import GraphFormat
from ..io.edges_container import EdgesContainer


def analyse_degrees(ec: EdgesContainer) -> dict:
    v = ec.vertices_count
    outdeg = np.bincount(ec.src_ids, minlength=v)
    indeg = np.bincount(ec.dst_ids, minlength=v)
    log_bins = np.concatenate([[0], np.logspace(0, 24, 25, base=2)]).astype(
        np.int64)

    def hist(deg):
        h, _ = np.histogram(deg, bins=log_bins)
        return h

    return {
        "vertices": v,
        "edges": ec.edges_count,
        "avg_degree": ec.edges_count / max(v, 1),
        "max_out_degree": int(outdeg.max()) if v else 0,
        "max_in_degree": int(indeg.max()) if v else 0,
        "zero_out_degree": int((outdeg == 0).sum()),
        "zero_in_degree": int((indeg == 0).sum()),
        "out_degree_hist_pow2": hist(outdeg).tolist(),
        "in_degree_hist_pow2": hist(indeg).tolist(),
    }


def estimate_memory_consumption(ec: EdgesContainer, cfg=None) -> dict:
    """Bytes estimates of the port's device graph: the COO, the CSRs of
    both directions, the tile copies of the adjacency and the routes (three
    vertex routes, and the advance route where cfg's format builds it,
    TILE_CSR, the default)."""
    from ..config import DEFAULT_CONFIG
    cfg = cfg or DEFAULT_CONFIG
    v, e = ec.vertices_count, ec.edges_count
    coo = 2 * 4 * e + (4 * e if ec.weights is not None else 0)
    csr_dir = 8 * (v + 1) + 4 * e
    vertex_routes = 3 * 2 * 4 * v
    route = vertex_routes
    if cfg.graph_format == GraphFormat.TILE_CSR:
        n_slots = 1 << int(np.ceil(np.log2(max(2 * e, 256))))  # rough: ~1.3x pad
        route += n_slots * (2 * 4 + 2)
    return {
        "coo_bytes": coo,
        "csr_both_directions_bytes": 2 * csr_dir,
        "tile_adj_bytes_approx": int(2 * 4 * e * 1.4),
        "route_bytes_approx": route,
    }


def component_statistics(labels: np.ndarray) -> dict:
    uniq, counts = np.unique(labels, return_counts=True)
    return {
        "components": int(len(uniq)),
        "largest": int(counts.max()),
        "singletons": int((counts == 1).sum()),
    }


def print_graph_info(ec: EdgesContainer) -> None:
    s = analyse_degrees(ec)
    print(f"|V| = {s['vertices']}, |E| = {s['edges']}, "
          f"avg degree = {s['avg_degree']:.2f}")
    print(f"max out/in degree: {s['max_out_degree']}/{s['max_in_degree']}")
    print(f"zero out/in degree: {s['zero_out_degree']}/{s['zero_in_degree']}")
