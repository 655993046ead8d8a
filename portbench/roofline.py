"""Peaks of the card and the bytes a kernel's call must move.

PEAKS holds NVIDIA's published figures for one H100 SXM (80 GB HBM3) at
its full 700 W power limit; the harness prints the card's own limit
beside every run. A roofline share is the least time the card could take
for a call (its bytes over the memory bandwidth; the operations of the
kernels here are far below their bound) over the time the call's kernels
took on the device.

Bytes count each input read once and each output written once, over the
graph's real |V| and |E|: never its padded v_pad, whose rows a call may
visit but need not.
"""
from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "fp32_flops_per_s": 67e12},
}


def pull_bytes(v: int, e: int) -> int:
    """One unweighted advance pull of 4-byte values over a CSR of v rows
    and e slots: row_ptr (v + 1 int32) and col_idx (e int32) read, the
    source value of every vertex read once, one output per row written."""
    return 4 * (v + 1) + 4 * e + 4 * v + 4 * v


def share_pct(nbytes: float, device_seconds: float, kind: str):
    """100 x the least time for nbytes at the card's bandwidth over the
    device time the kernels took; None for a card PEAKS does not hold."""
    if kind not in PEAKS:
        return None
    return 100.0 * nbytes / PEAKS[kind]["hbm_bytes_per_s"] / device_seconds
