"""Profiling and tracing hooks (port of
vectorgraphlibrary_tpu/runtime/profiling.py).

The reference pairs its `performance_stats` singleton with NEC ftrace
compiler hooks (`graph_library.h:22-24`, `apps/Makefile:36-38`). Here the
per-primitive accounting lives in runtime/perf_stats.py, and this module
adds the device-level layer: torch.profiler traces (CPU and CUDA activity)
written as Chrome traces, with named regions per call, and a dump of the
CUDA caching allocator's state. Nothing is recorded unless asked for.

    from vectorgraphlibrary_tpu_torch.runtime import profiling
    with profiling.trace("/tmp/vgl_trace"):      # writes a Chrome trace
        with profiling.annotate("advance:pr"):
            ranks, _ = pr.vgl_page_rank(graph)

VGL_TRACE_DIR=<dir> makes the apps (apps/app_common.py) trace their
measured rounds, one region per round.
"""
from __future__ import annotations

import contextlib
import os
import pickle
import time
from typing import Iterator, Optional

import torch

TRACE_DIR_ENV = "VGL_TRACE_DIR"


def trace_dir_from_env() -> Optional[str]:
    return os.environ.get(TRACE_DIR_ENV) or None


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """torch.profiler over the block (CPU activity, and CUDA activity where
    a card is visible), written to log_dir as trace_<pid>_<ns>.json, a
    Chrome trace; no-op when log_dir is falsy."""
    if not log_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """A named region in the trace (torch.profiler.record_function)."""
    return torch.profiler.record_function(name)


def step_annotate(name: str, step: int):
    """The region of one iteration, named `name#step`."""
    return torch.profiler.record_function(f"{name}#{step}")


def _device_us(evt) -> float:
    """An operator's own device time (us), by whichever name this torch
    gives it."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile_call(fn, top: int = 8) -> dict:
    """One call of fn under torch.profiler on the card: its wall seconds
    (host clock to a synchronize), the device's busy seconds (the sum of
    the kernels' and copies' durations) and their share of the wall, and
    the `top` operators by their own device time, each with its calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e6
    ops = sorted(((_device_us(e), e.key, e.count)
                  for e in prof.key_averages()), reverse=True)[:top]
    return {"wall_s": wall, "device_busy_s": busy,
            "busy_share": busy / wall if wall else None,
            "top": [{"op": k, "device_ms": us / 1e3, "calls": n}
                    for us, k, n in ops if us > 0]}


def device_memory_profile(path: str, device=None) -> None:
    """Pickle the CUDA caching allocator's state
    (torch.cuda.memory_snapshot(): its segments and blocks, with the
    allocation stacks where memory history is recorded) to `path`: which
    tensors hold the card's memory. It is not a pprof profile, as the JAX
    package's is; torch.cuda.memory._snapshot's viewer reads it. `device`
    (default the current CUDA device) keeps only that card's segments.
    Raises without a CUDA device, before opening `path`."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_memory_profile: no CUDA device is "
                           "available")
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        raise ValueError(f"device_memory_profile: {device} is not a CUDA "
                         f"device")
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    segments = [s for s in torch.cuda.memory_snapshot()
                if s["device"] == index]
    with open(path, "wb") as f:
        pickle.dump(segments, f)
