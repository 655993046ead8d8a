"""Tile-layout helpers (port of vectorgraphlibrary_tpu/ops/tiles.py).

A bucket's slots are a row-major (rows_pad, width) array, one vertex-row per
array row, for every width. The reference packs narrow buckets lane-major into
128-wide rows and reduces or broadcasts them through group-matrix products on
its matrix unit; that packing is the same row-major order seen through another
shape (graph/device.py there), so here a per-row reduction is a reduction over
dim 1 of the (rows_pad, width) tile (ops/advance.advance_cells).
"""
from __future__ import annotations

import torch


def row_ids(row_start: int, rows_pad: int, width: int,
            device) -> torch.Tensor:
    """(rows_pad, width) int32: owning vertex-row id of each slot."""
    ids = torch.arange(row_start, row_start + rows_pad, dtype=torch.int32,
                       device=device)
    return ids[:, None].expand(-1, width)
