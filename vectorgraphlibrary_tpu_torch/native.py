"""The Beneš router, host C++ bound with ctypes (port of
vectorgraphlibrary_tpu/native.py:48-114).

The source, csrc_host/benes.cpp, is built at first use by the host C++
compiler (`CXX`, else g++) into the gitignored .cache/torch_kernels/, keyed by
a hash of the source and the flags, beside the nvcc kernels. A failed build
raises: there is no slower fallback router, since a numpy router would take
minutes at the 2^24 slots of an RMAT-18 advance route.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .ops.cuda import build

_SRC = Path(__file__).resolve().parent / "csrc_host" / "benes.cpp"
# no -march=native: the library may be built on one host and run on another
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _cxx() -> str:
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if found is None:
        raise RuntimeError(f"host C++ compiler {cxx!r} not found (set CXX); "
                           "the Beneš router is built from csrc_host/ at "
                           "first use")
    return found


def load_router() -> ctypes.CDLL:
    """Build (once per source hash) and load the router library."""
    global _lib
    with _lock:
        if _lib is None:
            so, _, _ = build.compile_shared("libvgl_router", [_SRC], _cxx(),
                                            CXX_FLAGS, ("-shared", "-pthread"))
            lib = ctypes.CDLL(str(so))
            lib.benes_route.argtypes = [ctypes.c_int64] + [ctypes.c_void_p] * 4
            lib.benes_route.restype = ctypes.c_int
            _lib = lib
        return _lib


def benes_route(perm: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Beneš stage masks and lane indices for y = x[perm], |perm| = 2^k >= 128.

    Returns (in_masks uint8 [levels, n], out_masks uint8 [levels, n],
    lane_idx int32 [n]) with levels = log2(n) - 7, as the JAX package's
    native.benes_route does. perm must be a permutation of range(n)."""
    n = len(perm)
    if n < 128 or n & (n - 1):
        raise ValueError(f"benes_route: n = {n} is not a power of two >= 128")
    perm64 = np.ascontiguousarray(perm, dtype=np.int64)
    seen = np.zeros(n, bool)
    if perm64.min() < 0 or perm64.max() >= n:
        raise ValueError("benes_route: perm holds values outside range(n)")
    seen[perm64] = True
    if not seen.all():
        raise ValueError("benes_route: perm is not a permutation of range(n)")
    levels = n.bit_length() - 1 - 7
    in_masks = np.empty((levels, n), np.uint8)
    out_masks = np.empty((levels, n), np.uint8)
    lane_idx = np.empty(n, np.int32)
    rc = load_router().benes_route(
        n, perm64.ctypes.data, in_masks.ctypes.data, out_masks.ctypes.data,
        lane_idx.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"benes_route failed (rc={rc})")
    return in_masks, out_masks, lane_idx
