"""Result verification against sequential oracles.

Capability match for the reference `verify_results.h`:
- `verify_results`: elementwise compare with float epsilon (:32-92, are_same :9-28),
  printing the "error count: N" contract line the harness parses
  (`apps/scripts/settings.py:42`);
- `equal_components`: relabel-invariant component compare via bidirectional maps
  (:197-254);
- `verify_colors`: coloring validity property check (:291-319);
- `verify_ranking_results`: mean-difference ranking check (:96-148).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

FLOAT_EPS = 1.0e-4


def _are_same(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if np.issubdtype(a.dtype, np.floating) or np.issubdtype(b.dtype, np.floating):
        af = a.astype(np.float64)
        bf = b.astype(np.float64)
        both_inf = np.isinf(af) & np.isinf(bf) & (np.sign(af) == np.sign(bf))
        denom = np.maximum(np.maximum(np.abs(af), np.abs(bf)), 1.0)
        with np.errstate(invalid="ignore"):
            close = np.abs(af - bf) / denom < FLOAT_EPS
        return both_inf | close
    return a == b


def verify_results(got: np.ndarray, want: np.ndarray,
                   first_print: int = 10) -> int:
    """Elementwise compare; prints and returns the error count."""
    same = _are_same(np.asarray(got), np.asarray(want))
    errors = int((~same).sum())
    if errors:
        idx = np.flatnonzero(~same)[:first_print]
        for i in idx:
            print(f"  mismatch at {i}: got {got[i]} want {want[i]}")
    print(f"error count: {errors}")
    return errors


def equal_components(got: np.ndarray, want: np.ndarray) -> int:
    """Component labels equal up to relabeling (bidirectional injective maps)."""
    got = np.asarray(got)
    want = np.asarray(want)
    errors = 0
    for a, b in ((got, want), (want, got)):
        # map a-label -> first seen b-label; any disagreement is an error
        order = np.argsort(a, kind="stable")
        asorted, bsorted = a[order], b[order]
        grp_start = np.ones(len(a), bool)
        grp_start[1:] = asorted[1:] != asorted[:-1]
        rep = np.maximum.accumulate(np.where(grp_start, np.arange(len(a)), 0))
        errors += int((bsorted != bsorted[rep]).sum())
    print(f"error count: {errors}")
    return errors


def verify_colors(ec, colors: np.ndarray) -> int:
    """No edge may connect same-colored distinct endpoints."""
    colors = np.asarray(colors)
    bad = (colors[ec.src_ids] == colors[ec.dst_ids]) & (ec.src_ids != ec.dst_ids)
    errors = int(bad.sum())
    print(f"error count: {errors}")
    return errors


def verify_ranking_results(got: np.ndarray, want: np.ndarray,
                           avg_tol: float = 1.0e-4) -> int:
    """Ranking arrays compare by mean absolute difference (reference :96-148)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).mean(), 1e-30)
    avg_diff = np.abs(got - want).mean() / scale
    errors = 0 if avg_diff < avg_tol else int((
        np.abs(got - want) / scale >= avg_tol).sum())
    print(f"avg difference: {avg_diff}")
    print(f"error count: {errors}")
    return errors
