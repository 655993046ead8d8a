"""Host-side COO edges container.

Capability match for the reference ``EdgesContainer``
(`vgl_runtime/graph_generation/edges_container.h:5-100`): raw (src_ids, dst_ids) COO
plus O(1) transpose, random shuffle, and binary save/load (the ``.el_container``
persistence path used by `apps/utilites/create_vgl_graphs.cpp:38-45`). TPU-native
difference: this is a NumPy host structure used only during import/preprocessing;
device-resident layouts are built from it by `graph/` (SURVEY.md §7.2 step 2).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

_MAGIC = b"VGLTPUEL1"


@dataclass
class EdgesContainer:
    src_ids: np.ndarray                    # int32 [E]
    dst_ids: np.ndarray                    # int32 [E]
    vertices_count: int
    weights: Optional[np.ndarray] = None   # float32 [E], optional

    def __post_init__(self):
        self.src_ids = np.ascontiguousarray(self.src_ids, dtype=np.int32)
        self.dst_ids = np.ascontiguousarray(self.dst_ids, dtype=np.int32)
        if self.weights is not None:
            self.weights = np.ascontiguousarray(self.weights, dtype=np.float32)

    @property
    def edges_count(self) -> int:
        return int(self.src_ids.shape[0])

    def derived(self, key, build):
        """A structure derived from these edges (such as max-flow's residual
        graph), made by build() at the first call with `key` and kept with
        the container, whose arrays are not changed once it is made. It is
        no field: containers compare and save without it."""
        cache = self.__dict__.setdefault("_derived", {})
        if key not in cache:
            cache[key] = build()
        return cache[key]

    def transposed(self) -> "EdgesContainer":
        """O(1) transpose via array swap (reference edges_list transpose)."""
        return EdgesContainer(self.dst_ids, self.src_ids, self.vertices_count,
                              self.weights)

    def random_shuffle_edges(self, seed: int = 0) -> "EdgesContainer":
        rng = np.random.default_rng(seed)
        perm = rng.permutation(self.edges_count)
        w = self.weights[perm] if self.weights is not None else None
        return EdgesContainer(self.src_ids[perm], self.dst_ids[perm],
                              self.vertices_count, w)

    def with_random_weights(self, seed: int = 0, lo: float = 1.0,
                            hi: float = 100.0) -> "EdgesContainer":
        rng = np.random.default_rng(seed)
        w = rng.uniform(lo, hi, self.edges_count).astype(np.float32)
        return EdgesContainer(self.src_ids, self.dst_ids, self.vertices_count, w)

    def remove_self_loops_and_duplicates(self) -> "EdgesContainer":
        keep = self.src_ids != self.dst_ids
        src, dst = self.src_ids[keep], self.dst_ids[keep]
        w = self.weights[keep] if self.weights is not None else None
        key = src.astype(np.int64) * self.vertices_count + dst
        _, idx = np.unique(key, return_index=True)
        w = w[idx] if w is not None else None
        return EdgesContainer(src[idx], dst[idx], self.vertices_count, w)

    # -- binary persistence (.el_container analog) --
    def save_to_binary_file(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(_MAGIC)
            has_w = 1 if self.weights is not None else 0
            f.write(struct.pack("<qqq", self.vertices_count, self.edges_count, has_w))
            f.write(self.src_ids.tobytes())
            f.write(self.dst_ids.tobytes())
            if self.weights is not None:
                f.write(self.weights.tobytes())

    @staticmethod
    def load_from_binary_file(path: str) -> "EdgesContainer":
        with open(path, "rb") as f:
            magic = f.read(len(_MAGIC))
            if magic != _MAGIC:
                raise ValueError(f"{path}: not a VGL-TPU edges container")
            v, e, has_w = struct.unpack("<qqq", f.read(24))
            src = np.frombuffer(f.read(4 * e), dtype=np.int32)
            dst = np.frombuffer(f.read(4 * e), dtype=np.int32)
            w = np.frombuffer(f.read(4 * e), dtype=np.float32) if has_w else None
            return EdgesContainer(src.copy(), dst.copy(), v,
                                  w.copy() if w is not None else None)
