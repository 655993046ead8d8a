"""The route-gather kernel: wrapper, plain PyTorch version, loader and launch count.

`route_gather_finish` computes, for every output slot i,

    out[i] = keep(i) ? wop(x[idx[i]], weights[i]) : ident

with keep(i) = (flags[i] & 1) and not (exclude_self_loops and flags[i] & 2)
when flags are given, else true. It replaces the reference's route kernels
(vectorgraphlibrary_tpu/ops/pallas/route_fused.py: _big_kernel, _mid_kernel
and the _finish epilogue); the source note in csrc/route_gather.cu says what
bounds it on the card.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the hand-written kernel (built by nvcc for sm_90a at first use) or
raises. There is no fallback from one to the other.
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
from typing import Optional

import torch

_PKG_DIR = Path(__file__).resolve().parents[2]
_CSRC = _PKG_DIR / "csrc"
# gitignored: the repository's .gitignore lists .cache/
_BUILD_DIR = _PKG_DIR.parent / ".cache" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_WOPS = {None: 0, "add": 1, "min": 2, "max": 3, "mul": 4}
_ENTRY = {torch.float32: ("vgl_route_gather_f32", ctypes.c_float),
          torch.int32: ("vgl_route_gather_i32", ctypes.c_int),
          torch.int8: ("vgl_route_gather_i8", ctypes.c_int)}

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
        lib = ctypes.CDLL(str(so))
        for name, ident_t in set(_ENTRY.values()):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 5 + [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ident_t,
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def route_gather_finish_ref(x: torch.Tensor, idx: torch.Tensor,
                            flags: Optional[torch.Tensor] = None,
                            weights: Optional[torch.Tensor] = None,
                            weight_op: Optional[str] = None,
                            exclude_self_loops: bool = False,
                            ident=0) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arguments, same result)."""
    y = x[idx.long()]
    if weight_op is not None:
        op = {"add": torch.add, "min": torch.minimum, "max": torch.maximum,
              "mul": torch.mul}[weight_op]
        y = op(y, weights)
    if flags is not None:
        keep = (flags & 1) != 0
        if exclude_self_loops:
            keep &= (flags & 2) == 0
        y = torch.where(keep, y, torch.tensor(ident, dtype=y.dtype,
                                              device=y.device))
    return y


def route_gather_finish(x: torch.Tensor, idx: torch.Tensor,
                        flags: Optional[torch.Tensor] = None,
                        weights: Optional[torch.Tensor] = None,
                        weight_op: Optional[str] = None,
                        exclude_self_loops: bool = False,
                        ident=0) -> torch.Tensor:
    """out[i] = keep(i) ? wop(x[idx[i]], weights[i]) : ident (module doc).

    x: f32, i32 or int8 [m]; idx: int32 [n] with values in [0, m), which
    the kernel does not check (make_route_plan checks its plans on the
    host); flags: uint8 [n] or None; weights: x's dtype [n] iff weight_op."""
    if weight_op not in _WOPS:
        raise ValueError(f"unknown weight_op {weight_op!r}")
    if (weights is None) != (weight_op is None):
        raise ValueError("weights must be given exactly when weight_op is")
    if x.device.type == "cpu":
        return route_gather_finish_ref(x, idx, flags, weights, weight_op,
                                       exclude_self_loops, ident)
    if x.device.type != "cuda":
        raise ValueError(f"route_gather_finish: no kernel for {x.device}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"route_gather_finish: unsupported dtype {x.dtype}")
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise TypeError("idx must be a 1-D int32 tensor")
    n = idx.shape[0]
    for name, t, dtype in (("x", x, x.dtype), ("idx", idx, torch.int32),
                           ("flags", flags, torch.uint8),
                           ("weights", weights, x.dtype)):
        if t is None:
            continue
        if t.device != x.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {dtype} tensor on "
                             f"{x.device}, got {t.dtype} on {t.device}")
        if name in ("flags", "weights") and t.shape != (n,):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != ({n},)")
    if x.dim() != 1:
        raise ValueError("x must be 1-D")
    fn_name, _ = _ENTRY[x.dtype]
    fn = getattr(load_library(), fn_name)
    out = torch.empty(n, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ident_c = float(ident) if x.dtype == torch.float32 else int(ident)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), idx.data_ptr(),
                None if flags is None else flags.data_ptr(),
                None if weights is None else weights.data_ptr(),
                out.data_ptr(), n, int(bool(exclude_self_loops)),
                _WOPS[weight_op], ident_c, stream)
    if rc != 0:
        raise RuntimeError(f"route_gather kernel launch failed: CUDA error {rc}")
    route_gather_finish.launches += 1
    return out


route_gather_finish.launches = 0
