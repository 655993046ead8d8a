"""Build, load and launch the port's CUDA kernels (every csrc/*.cu in one
library).

nvcc compiles every source for sm_90a, one process per source, all started
together, and links them into one shared library with a plain C interface,
at first use, into the gitignored .cache/torch_kernels/, keyed by a hash of
the sources and the flags; ctypes loads it. `compile_shared` is the build
step itself; the host router (native.py) uses it with the host compiler.

Every wrapper launches through one helper, `Launcher`: one object per C
entry, made when its module is imported, which resolves the entry at its
first launch with its argument types declared once, and on every launch
appends the current stream's raw handle, calls the entry and raises on the
CUDA error code it returns. The launch path is host time that a wrapper
pays on top of the kernel (a vertex route's kernel takes a few microseconds
on the card), so each step of it is the cheapest that measured well on the
H100's host (chip_smoke.py phase 9 prints the breakdown):

- the raw stream by torch._C._cuda_getCurrentRawStream(device), the call
  torch's own generated code makes (torch._dynamo.device_interface,
  torch._inductor), in place of torch.cuda.current_stream(device)
  .cuda_stream, which builds a Stream object per call;
- no device context when the process sees one card (every CUDA tensor is
  then on the current device), else torch.cuda.device(index) only when the
  tensor is not on the current device;
- the caller passes the tensor's device index (Tensor.get_device(), an int)
  rather than a torch.device object.
"""
from __future__ import annotations

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
# what the sources include from csrc/ (on nvcc's -I path), in the hash
HEADERS = tuple(sorted(_CSRC.glob("*.cuh")))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v", f"-I{_CSRC}")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
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
                   link_flags: Sequence[str] = ("-shared",),
                   headers: Sequence[Path] = ()
                   ) -> tuple[Path, str, float]:
    """Compile each of `sources` to an object with `flags`, all at once, and
    link them with `link_flags` into .cache/torch_kernels/<stem>_<hash>.so,
    once per hash of the sources, the `headers` they include and the
    flags. Safe for concurrent
    processes: each writes its own temporary files and renames the library
    into place. Returns the library's path, the compiler's output and the
    build's seconds (both empty when the library was already built). Raises
    if the build fails."""
    h = hashlib.sha256()
    for src in (*sources, *headers):
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
            "libvgl_kernels", sorted(_CSRC.glob("*.cu")), _nvcc(), NVCC_FLAGS,
            headers=HEADERS)
        _lib = ctypes.CDLL(str(so))
        return _lib


_one_card: Optional[bool] = None     # the process sees exactly one card


class Launcher:
    """One C entry of the kernel library: `launcher(device_index, *args)`
    calls it with args and the current stream of that device appended, and
    raises RuntimeError if it returns a CUDA error (a launch the card
    refused). `argtypes` are the ctypes types of the entry's arguments
    before the stream (pointers as c_void_p); the entry returns int."""

    __slots__ = ("name", "argtypes", "fn")

    def __init__(self, name: str, *argtypes):
        self.name = name
        self.argtypes = (*argtypes, ctypes.c_void_p)
        self.fn = None

    def __call__(self, device_index: int, *args) -> None:
        global _one_card
        fn = self.fn
        if fn is None:
            fn = getattr(load_library(), self.name)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self.fn = fn
            if _one_card is None:
                _one_card = torch.cuda.device_count() == 1
        stream = torch._C._cuda_getCurrentRawStream(device_index)
        if _one_card or device_index == torch.cuda.current_device():
            rc = fn(*args, stream)
        else:
            with torch.cuda.device(device_index):
                rc = fn(*args, stream)
        if rc:
            raise RuntimeError(f"{self.name}: kernel launch failed, CUDA "
                               f"error {rc}")
