"""Tile-layout helpers (port of vectorgraphlibrary_tpu/ops/tiles.py).

A bucket's slots are a row-major (rows_pad, width) array, one vertex-row per
array row, for every width. The reference packs narrow buckets lane-major into
128-wide rows and reduces or broadcasts them through group-matrix products on
its matrix unit; that packing is the same row-major order seen through another
shape (graph/device.py there), so here a per-row reduction is a reduction over
dim 1 of a `view(rows_pad, width)` and a broadcast is an `expand`.
"""
from __future__ import annotations

import torch


def group_reduce_flat(msg: torch.Tensor, width: int, mon,
                      rows: int) -> torch.Tensor:
    """Flat [rows_pad * width] masked messages -> per-row reduction [rows].
    Messages must already carry the monoid identity in invalid slots."""
    return mon.reduce_axis(msg.view(-1, width), 1)[:rows]


def broadcast_rows_flat(x_rows: torch.Tensor, width: int) -> torch.Tensor:
    """[rows_pad] per-row values -> (rows_pad, width) slot values, each row's
    value repeated over its width slots (a view; no copy)."""
    return x_rows[:, None].expand(-1, width)


def row_ids(row_start: int, rows_pad: int, width: int,
            device) -> torch.Tensor:
    """(rows_pad, width) int32: owning vertex-row id of each slot."""
    ids = torch.arange(row_start, row_start + rows_pad, dtype=torch.int32,
                       device=device)
    return ids[:, None].expand(-1, width)
