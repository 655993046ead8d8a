"""Build and load the port's CUDA kernels (every csrc/*.cu in one library).

nvcc compiles every source for sm_90a, one process per source, all started
together, and links them into one shared library with a plain C interface,
at first use, into the gitignored .cache/torch_kernels/, keyed by a hash of
the sources and the flags; ctypes loads it. Each wrapper module asks
for its entry points through `entry`, which declares their argument types.
`compile_shared` is the build step itself; the host router (native.py) uses
it with the host compiler. `on_device` is the device context of a launch.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional, Sequence

import torch

_PKG_DIR = Path(__file__).resolve().parents[2]
_CSRC = _PKG_DIR / "csrc"
# gitignored: the repository's .gitignore lists .cache/
_BUILD_DIR = _PKG_DIR.parent / ".cache" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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


def compile_shared(stem: str, sources: Sequence[Path], compiler: str,
                   flags: Sequence[str],
                   link_flags: Sequence[str] = ("-shared",)
                   ) -> tuple[Path, str, float]:
    """Compile each of `sources` to an object with `flags`, all at once, and
    link them with `link_flags` into .cache/torch_kernels/<stem>_<hash>.so,
    once per hash of the sources and the flags. Safe for concurrent
    processes: each writes its own temporary files and renames the library
    into place. Returns the library's path, the compiler's output and the
    build's seconds (both empty when the library was already built). Raises
    if the build fails."""
    h = hashlib.sha256()
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join([*flags, *link_flags]).encode())
    so = _BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so, "", 0.0
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    objs = [so.with_suffix(f".{i}.{os.getpid()}.o")
            for i in range(len(sources))]
    cmds = [[compiler, *flags, "-c", "-o", str(o), str(s)]
            for o, s in zip(objs, sources)]
    cmds.append([compiler, *link_flags, "-o", str(tmp), *map(str, objs)])
    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(len(sources)) as pool:
            procs = list(pool.map(lambda c: subprocess.run(
                c, capture_output=True, text=True), cmds[:-1]))
        if all(p.returncode == 0 for p in procs):
            procs.append(subprocess.run(cmds[-1], capture_output=True,
                                        text=True))
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    log = "".join(p.stdout + p.stderr for p in procs)
    if any(p.returncode != 0 for p in procs):
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{compiler} failed:\n{log}")
    os.replace(tmp, so)
    return so, log, seconds


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the port's kernel library."""
    global _lib, build_log, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        so, build_log, build_seconds = compile_shared(
            "libvgl_kernels", sorted(_CSRC.glob("*.cu")), _nvcc(), NVCC_FLAGS)
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


def on_device(device: torch.device):
    """The context to launch on `device` in: none when it is already the
    current device (the usual case), else torch.cuda.device(device)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)
