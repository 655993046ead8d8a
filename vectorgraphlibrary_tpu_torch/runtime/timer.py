"""Timers (port of vectorgraphlibrary_tpu/runtime/timer.py; reference
`vgl_runtime/helpers/timer/timer.h:5-38`).

PyTorch returns before the card finishes, so a bare host clock around a
call measures its enqueue. ``DeviceTimer`` on a CUDA device records a CUDA
event pair on the current stream (the stream the port's kernels launch on)
and reads their elapsed time after the stop event completes: the C++
reference's CUDA-event path. On the CPU it uses the host clock.
"""
from __future__ import annotations

import time

import torch


class Timer:
    """Host clock."""

    def __init__(self):
        self._start = 0.0
        self._elapsed = 0.0

    def start(self) -> "Timer":
        self._start = time.perf_counter()
        return self

    def stop(self) -> float:
        self._elapsed = time.perf_counter() - self._start
        return self._elapsed

    @property
    def seconds(self) -> float:
        return self._elapsed

    @property
    def ms(self) -> float:
        return self._elapsed * 1.0e3

    def print_bandwidth_stats(self, name: str, bytes_moved: float) -> None:
        gbps = bytes_moved / max(self._elapsed, 1e-12) / 1.0e9
        print(f"{name} time: {self.ms:.3f} ms, bandwidth: {gbps:.2f} GB/s")


class DeviceTimer(Timer):
    """CUDA events on `device`'s current stream (default: the current CUDA
    device); the host clock when `device` is the CPU. stop() waits for the
    stop event and returns the seconds between the two events."""

    def __init__(self, device=None):
        super().__init__()
        self.device = torch.device("cuda" if device is None else device)
        self._events = None

    def start(self) -> "DeviceTimer":
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(stream)
            return self
        super().start()
        return self

    def stop(self, result=None) -> float:
        if self.device.type == "cuda":
            begin, end = self._events
            end.record(torch.cuda.current_stream(self.device))
            end.synchronize()
            self._elapsed = begin.elapsed_time(end) / 1.0e3
            return self._elapsed
        block(result)
        return super().stop()


def _cuda_devices(tree, found: set) -> set:
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            found.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, found)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, found)
    return found


def block(tree):
    """Wait until the CUDA devices that hold the tensors of `tree` (a tensor
    or a nested dict, list or tuple of them) have finished their queued
    work; returns the tree."""
    for dev in _cuda_devices(tree, set()):
        torch.cuda.synchronize(dev)
    return tree
