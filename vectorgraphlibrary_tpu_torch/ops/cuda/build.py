"""Build and load the port's CUDA kernels (every csrc/*.cu in one library).

nvcc compiles all sources for sm_90a into one shared library with a plain C
interface, at first use, into the gitignored .cache/torch_kernels/, keyed by a
hash of the sources and the flags; ctypes loads it. Each wrapper module asks
for its entry points through `entry`, which declares their argument types.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Sequence

_PKG_DIR = Path(__file__).resolve().parents[2]
_CSRC = _PKG_DIR / "csrc"
# gitignored: the repository's .gitignore lists .cache/
_BUILD_DIR = _PKG_DIR.parent / ".cache" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_entries: dict = {}
build_log = ""          # nvcc's output (ptxas register/spill report) of the build
build_seconds = 0.0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from csrc/ at first use")
    return found


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the port's kernel library."""
    global _lib, build_log, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        sources = sorted(_CSRC.glob("*.cu"))
        h = hashlib.sha256()
        for src in sources:
            h.update(src.name.encode())
            h.update(src.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        so = _BUILD_DIR / f"libvgl_kernels_{h.hexdigest()[:16]}.so"
        if not so.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)],
                capture_output=True, text=True)
            build_seconds = time.perf_counter() - t0
            build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{build_log}")
            os.replace(tmp, so)
        _lib = ctypes.CDLL(str(so))
        return _lib


def entry(name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The library's C function `name`, returning int (a CUDA error code),
    with its argument types declared (pointers and the stream as c_void_p)."""
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(load_library(), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn
