"""Word-packed Beneš stage masks, host numpy (copied from
vectorgraphlibrary_tpu/ops/pallas/route_fused.py:71-130, with the inverse).

The JAX package's fused route reads a route's stage masks as one int32 word
per slot (bit j = the swap decision of stage j), with the forward lane index
and the advance route's finish flags in spare bits. A graph saved on a TPU
carries only these words, so the port writes them (`build_word_masks`) and
reads them back into stage masks (`unpack_word_masks`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

# max mid (within-block) levels per half: lane bits live at 10..15 (+26)
_KB_MAX = 10
# big-stage words use bits [0, kq) and [16, 16+kq) plus flag bits 28-31
_KQ_MAX = 12


def split_levels(n: int) -> tuple[int, int]:
    """(kb, kq): number of mid (within-B-block) and big (super-block) exchange
    levels per half for an n-slot route. R = n/128 rows, B = 2^kb, Q = 2^kq."""
    r_levels = max(n.bit_length() - 1 - 7, 0)     # log2(R)
    kb = min(r_levels, _KB_MAX)
    kq = r_levels - kb
    return kb, kq


def build_word_masks(in_m: np.ndarray, out_m: np.ndarray, n: int,
                     lane_fwd: Optional[np.ndarray] = None,
                     flags_fwd: Optional[np.ndarray] = None,
                     flags_inv: Optional[np.ndarray] = None,
                     ) -> tuple[np.ndarray, np.ndarray | None]:
    """Pack per-stage bit masks (uint8 [levels, n]) into per-element words.

    mid_words  int32 [R, 128]: bit j    = in-half stage with row-dist B/2>>j
                               bit 16+j = out-half stage with row-dist 1<<j
                               bits 10..15 + 26 = forward lane-shuffle index
    big_words  int32 [R, 128]: bit j    = in-half stage with row-dist R/2>>j
                               bit 16+j = out-half stage with row-dist B<<j
    (big is None when kq == 0).  levels = kb + kq per half.

    flags_fwd/flags_inv (uint8 [n], bit0 = valid-slot, bit1 = self-loop) are
    packed into the words of the kernel that runs LAST in the respective
    direction — big_words when kq > 0 else mid_words — at bits 31/30 (fwd)
    and 29/28 (inv), indexed by that direction's OUTPUT slot position."""
    kb, kq = split_levels(n)
    levels = kb + kq
    if in_m.shape[0] != levels or kb > _KB_MAX or kq > _KQ_MAX:
        raise ValueError(f"masks of {in_m.shape[0]} levels for n = {n} "
                         f"(kb {kb}, kq {kq})")
    r = n // 128

    mid = np.zeros(n, np.uint32)
    for j in range(kb):
        mid |= in_m[kq + j].astype(np.uint32) << j
        mid |= out_m[levels - 1 - j].astype(np.uint32) << (16 + j)
    if lane_fwd is not None:
        lf = lane_fwd.reshape(-1).astype(np.uint32)
        mid |= (lf & 63) << 10
        mid |= (lf >> 6) << 26
    big = None
    if kq > 0:
        big = np.zeros(n, np.uint32)
        for j in range(kq):
            big |= in_m[j].astype(np.uint32) << j
            big |= out_m[kq - 1 - j].astype(np.uint32) << (16 + j)
    flag_target = big if big is not None else mid
    if flags_fwd is not None:
        f = flags_fwd.astype(np.uint32)
        flag_target |= (f & 1) << 31          # forward-output valid
        flag_target |= ((f >> 1) & 1) << 30   # forward-output self-loop
    if flags_inv is not None:
        f = flags_inv.astype(np.uint32)
        flag_target |= (f & 1) << 29          # inverse-output valid
        flag_target |= ((f >> 1) & 1) << 28   # inverse-output self-loop
    mid32 = mid.view(np.int32).reshape(r, 128)
    big32 = None if big is None else big.view(np.int32).reshape(r, 128)
    return mid32, big32


def _bit(words: np.ndarray, b: int) -> np.ndarray:
    return ((words >> np.uint32(b)) & np.uint32(1)).astype(np.uint8)


def word_flags(mid: np.ndarray, big: Optional[np.ndarray], n: int
               ) -> tuple[np.ndarray, np.ndarray]:
    """(flags_fwd, flags_inv), uint8 [n] each (bit0 valid, bit1 self-loop),
    from the flag bits of the words (big_words when kq > 0, else mid_words)."""
    _, kq = split_levels(n)
    w = big if kq > 0 else mid
    if w is None:
        raise ValueError(f"route of n = {n} carries flags but no "
                         f"{'big' if kq > 0 else 'mid'}_words")
    if w.shape != (n // 128, 128) or w.dtype != np.int32:
        raise ValueError(f"word masks: {w.dtype} {w.shape} for n = {n}")
    w = w.reshape(-1).view(np.uint32)
    return (_bit(w, 31) | (_bit(w, 30) << 1),
            _bit(w, 29) | (_bit(w, 28) << 1))


def unpack_word_masks(mid: np.ndarray, big: Optional[np.ndarray], n: int):
    """Inverse of build_word_masks: (in_m uint8 [levels, n], out_m uint8
    [levels, n], lane_fwd int32 [n // 128, 128], flags_fwd uint8 [n],
    flags_inv uint8 [n]). The flags are zero where none were packed."""
    kb, kq = split_levels(n)
    levels = kb + kq
    if mid.shape != (n // 128, 128) or (
            big is not None and big.shape != mid.shape):
        raise ValueError(f"word masks of shape {mid.shape} for n = {n}")
    m = mid.reshape(-1).view(np.uint32)
    in_m = np.empty((levels, n), np.uint8)
    out_m = np.empty((levels, n), np.uint8)
    for j in range(kb):
        in_m[kq + j] = _bit(m, j)
        out_m[levels - 1 - j] = _bit(m, 16 + j)
    if kq > 0:
        if big is None:
            raise ValueError(f"route of n = {n} has kq = {kq} but no "
                             "big_words")
        b = big.reshape(-1).view(np.uint32)
        for j in range(kq):
            in_m[j] = _bit(b, j)
            out_m[kq - 1 - j] = _bit(b, 16 + j)
    lane = ((m >> np.uint32(10)) & np.uint32(63)) | (
        ((m >> np.uint32(26)) & np.uint32(1)) << np.uint32(6))
    flags_fwd, flags_inv = word_flags(mid, big, n)
    return (in_m, out_m, lane.astype(np.int32).reshape(n // 128, 128),
            flags_fwd, flags_inv)
