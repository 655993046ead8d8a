"""Profiling and tracing hooks (port of
vectorgraphlibrary_tpu/runtime/profiling.py).

The reference pairs its `performance_stats` singleton with NEC ftrace
compiler hooks (`graph_library.h:22-24`, `apps/Makefile:36-38`). Here the
per-primitive accounting lives in runtime/perf_stats.py, and this module
adds the device-level layer: torch.profiler traces (CPU and CUDA activity)
written as Chrome traces, with named spans (`annotate`), and a dump of
the CUDA caching allocator's state. Nothing is recorded unless asked for:
without a profiler a span costs one check of its state.

    from vectorgraphlibrary_tpu_torch.runtime import profiling
    with profiling.trace("/tmp/vgl_trace"):      # writes a Chrome trace
        with profiling.annotate("advance:pr"):
            ranks, _ = pr.vgl_page_rank(graph)

VGL_TRACE_DIR=<dir> makes the apps (apps/app_common.py) trace their
measured rounds, one region per round.
"""
from __future__ import annotations

import collections
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


def annotate(name: str, keep: bool = False):
    """A span named `name` over a block, on the profiler's host clock.

    While no torch.profiler records, it is one shared no-op context: a
    span in a hot loop costs one check of the profiler's state. While one
    records, it is a RecordFunction of the profiler's function scope, the
    scope of the aten operators: a user-scope record_function would also
    lay a copy of the span onto the device's timeline, where a reader of
    the trace would take it for device work. Spans nest by the block
    structure of the one host thread. The port's own spans are named
    vgl.<layer>...

    keep=True also appends (name, start, end) in time.perf_counter
    seconds to a bounded list (`kept_spans`), whether or not a profiler
    records: for the few long phases of a graph import."""
    if keep:
        return _kept_span(name)
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return torch._C._profiler._RecordFunctionFast(name)


_NO_SPAN = contextlib.nullcontext()
_KEPT: collections.deque = collections.deque(maxlen=256)


@contextlib.contextmanager
def _kept_span(name: str) -> Iterator[None]:
    with annotate(name):
        start = time.perf_counter()
        try:
            yield
        finally:
            _KEPT.append((name, start, time.perf_counter()))


def kept_spans() -> list:
    """The kept spans, oldest end first: [(name, start_s, end_s)] on
    time.perf_counter's clock (the last 256)."""
    return list(_KEPT)


def step_annotate(name: str, step: int):
    """The span of one iteration, named `name#step`."""
    return annotate(f"{name}#{step}")


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
