"""vectorgraphlibrary_tpu_torch — the PyTorch/CUDA port of vectorgraphlibrary_tpu.

A second package beside the JAX one, which stays the reference: the same host
import pipeline and tile layout, with every TPU kernel of a ported path
replaced by a hand-written CUDA kernel for Hopper (csrc/, built by nvcc at
first use, never when a module is imported). It imports torch and never jax.
The names below are the JAX package's top-level API.
"""

from .config import (VGLConfig, DEFAULT_CONFIG, GraphFormat, Sparsity,
                     SyntheticGraphType, TraversalDirection)
from .io.edges_container import EdgesContainer
from .io import generation
from .graph.device import VGLGraph, import_graph
from .graph.vertices import VertexArray, vertex_array, reorder, as_original_numpy
from .graph.edges import EdgeArray, build_edge_array_from_host, edge_array_from_flat
from .graph import frontier as frontier_api
from .graph.frontier import Frontier
from .ops.advance import advance_pull, advance_push_sparse
from .ops.compute import compute
from .ops.reduce import reduce
from .ops.frontier_ops import generate_new_frontier
from .ops import monoid
from .runtime.perf_stats import performance_stats, PerformanceStats
from .runtime.timer import Timer, DeviceTimer

__version__ = "0.1.0"
