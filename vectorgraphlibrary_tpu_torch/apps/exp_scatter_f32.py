"""The f32 min scatter on the card at the sparse SSSP sweep's shapes (card
only): scatter_combine(target, idx, msg, "min") of 65,536 messages, an
eighth dropped, into an f32 [2^20] target, for three targets: +inf (every
message lands), random values of the messages' range (about half land), and
values below every message (none lands). For each, the wrapper's time by
CUDA events (mean of 100 calls, median of 3) and the kernel's device time
by torch.profiler (mean of 20 calls, the copy of the target left out).

    python -m vectorgraphlibrary_tpu_torch.apps.exp_scatter_f32
    PYTHONPATH=<checkout> python <this file>     # another checkout's kernel

The imports are absolute, so the file runs by its path against another
checkout of the package, to time two versions of the kernel in one call.
Prints one JSON line.
"""
from __future__ import annotations

import json
import statistics
import sys

import numpy as np
import torch

from vectorgraphlibrary_tpu_torch.ops.cuda import scatter_combine as scm

V, N, SEED = 1 << 20, 1 << 16, 42


def _events_ms(fn, reps: int = 100) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _kernel_device_ms(fn, reps: int = 20):
    """Mean device time of the scatter kernel per call; None where the
    profiler kept fewer than reps of its launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and "scatter_combine_f32" in e.name]
    if len(dev) != reps:
        return None
    return sum(e.time_range.elapsed_us() for e in dev) / reps / 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("exp_scatter_f32: no CUDA device", file=sys.stderr)
        return 1
    rng = np.random.default_rng(SEED)
    d = rng.integers(0, V, N)
    d[rng.permutation(N)[:N // 8]] = V
    idx = torch.from_numpy(d.astype(np.int32)).cuda()
    msg = torch.from_numpy(rng.uniform(1, 100, N).astype(np.float32)).cuda()
    targets = {
        "inf": torch.full((V,), float("inf"), device="cuda"),
        "random": torch.from_numpy(rng.uniform(1, 100, V).astype(
            np.float32)).cuda(),
        "below": torch.zeros(V, device="cuda")}
    out = {"device": torch.cuda.get_device_name(0), "source": scm.__file__}
    for name, target in targets.items():
        fn = lambda: scm.scatter_combine(target, idx, msg, "min")  # noqa: E731
        want = scm.scatter_combine_ref(target, idx, msg, "min")
        if not torch.equal(fn().view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"{name}: the kernel differs from its plain "
                                 f"version")
        out[name] = dict(
            events_ms=statistics.median(_events_ms(fn) for _ in range(3)),
            kernel_device_ms=_kernel_device_ms(fn))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
