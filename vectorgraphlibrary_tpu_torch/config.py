"""Unified configuration for the VGL framework (PyTorch/CUDA port; copied from
vectorgraphlibrary_tpu/config.py, with the device defaulting to "cuda").

The reference splits configuration across compile-time defines (`settings.h:43-154`)
and a runtime CLI parser (`vgl_runtime/helpers/cmd_parser/cmd_parser.h:10-72`). Here both
collapse into one typed config object (SURVEY.md §5 "Config / flag system"); apps may
override fields per-algorithm exactly as reference apps pre-override kernel constants
(`apps/bfs/bfs.cpp:1-11`).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class GraphFormat(enum.Enum):
    """Storage formats (reference `framework_types.h:48-56`).

    The TPU-native flagship is TILE_CSR: degree-sorted vertices + padded degree-bucket
    (SELL-C-sigma-like) adjacency tiles — the TPU analog of the reference's VectorCSR +
    VectorExtension layout (`vect_csr/vect_csr_graph.h:28-164`).
    """

    EDGES_LIST = "el"        # COO (reference edges_list_graph.h:9-70)
    CSR = "csr"              # plain CSR (reference csr/csr_graph.h:22)
    CSR_VG = "csr_vg"        # CSR + degree-bucket vertex groups (csr_vg_graph.h:27-80)
    TILE_CSR = "vect_csr"    # flagship: degree-sorted, tile-padded (vect_csr_graph.h)
    SHARDED_CSR = "sharded_csr"  # multi-chip edge-partitioned (sharded_csr_graph.h)

    @staticmethod
    def parse(name: str) -> "GraphFormat":
        aliases = {
            "el": GraphFormat.EDGES_LIST, "edges_list": GraphFormat.EDGES_LIST,
            "csr": GraphFormat.CSR,
            "csr_vg": GraphFormat.CSR_VG, "csr-vg": GraphFormat.CSR_VG,
            "vect_csr": GraphFormat.TILE_CSR, "vcsr": GraphFormat.TILE_CSR,
            "tile_csr": GraphFormat.TILE_CSR,
            "sharded_csr": GraphFormat.SHARDED_CSR,
        }
        try:
            return aliases[name.lower()]
        except KeyError as exc:
            raise ValueError(f"unknown graph format: {name!r}") from exc


class SyntheticGraphType(enum.Enum):
    RMAT = "rmat"
    RANDOM_UNIFORM = "ru"


class TraversalDirection(enum.Enum):
    """Vertex-array ordering tags (reference `vertices_array.h:16-77`)."""

    ORIGINAL = 0
    SCATTER = 1   # outgoing-degree-sorted order
    GATHER = 2    # incoming-degree-sorted order


class Sparsity(enum.Enum):
    """Frontier sparsity classes (reference `framework_types.h:156-160`)."""

    ALL_ACTIVE = 0
    DENSE = 1
    SPARSE = 2


@dataclasses.dataclass
class VGLConfig:
    """All framework tunables (union of reference settings.h + cmd_parser flags)."""

    # ---- hardware / layout tunables (analog of settings.h:43-87) ----
    lane_count: int = 128          # TPU lane dim (last-dim tiling unit)
    sublane_count: int = 8         # f32 sublane dim
    # Degree-class split — the TPU analog of VGL's vector_engine / vector_core /
    # collective three-way split (`nec_api.hpp:5-43`, settings.h:99-109):
    #   huge rows (deg > huge_degree_threshold) are row-split into fixed-width chunks
    #   ("vector engine" class); the rest live in power-of-two-width ELL buckets.
    huge_degree_threshold: int = 256
    huge_row_chunk: int = 512
    # ---- frontier sparsity switch thresholds (settings.h:111-125) ----
    dense_frontier_threshold: float = 0.03   # active ratio below which SPARSE wins
    # ---- bytes model for GB/s accounting (settings.h:140-154) ----
    int_elements_per_edge: float = 3.0
    # ---- runtime flags (cmd_parser.hpp:58-228) ----
    scale: int = 14                      # -s : log2 number of vertices
    avg_degree: int = 16                 # -e : edges per vertex
    synthetic_type: SyntheticGraphType = SyntheticGraphType.RMAT   # -rmat / -ru
    graph_format: GraphFormat = GraphFormat.TILE_CSR               # -format
    autotune_format: bool = False        # -format auto: autotuner picks
    load_path: Optional[str] = None      # -load
    import_path: Optional[str] = None    # -import (KONECT text)
    store_walk_paths: bool = False       # RW: also return the full walk paths
    check: bool = False                  # -check : verify vs sequential oracle
    iterations: int = 10                 # -it : benchmark rounds
    prim_stats: bool = True              # per-primitive profiling pass in apps
    device: str = "cuda"                 # -dev
    seed: int = 42
    # algorithm-specific knobs
    push_mode: bool = True               # -push / -pull
    all_active: bool = True              # -all-active / -partial-active
    algorithm_variant: str = "auto"      # -td/-bu/-do, -sv/-bfs-based/-purdoms
    max_iterations: int = 10_000         # safety bound for while loops
    convergence_tol: float = 1.0e-6
    # numerics. NOTE: the reference's safe-stores/deterministic-accumulation
    # switch (graph_abstractions_nec.h:332-333) has no analog here by design —
    # every combine is a functional monoid reduction, always deterministic
    # (see ARCHITECTURE.md "race handling").
    compute_dtype: str = "float32"

    def replace(self, **kw) -> "VGLConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = VGLConfig()
