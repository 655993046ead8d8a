"""How many of a window's kernels torch.profiler keeps, two ways (card only).

    python -m vectorgraphlibrary_tpu_torch.apps.exp_profiler [--windows 30]

chip_smoke.py times a kernel on the device from torch.profiler windows of
`reps` calls (its _device_events), and the profiler loses events: now and
then a whole window. This runs route_gather_finish on int32 vertex routes of
2^18 and 2^20 slots (random permutations: the sizes of the RMAT-18 and
RMAT-20 routes that chip_smoke.py's phase 9 times) in windows of 20 calls,
the two ways in turns:

- "new": a new torch.profiler.profile for every window (chip_smoke.py's
  way before this script);
- "acc": one profile object with acc_events=True, started and stopped once
  per window, its events kept across windows, each window's taken after its
  own marker.

For each way and size: the windows, the kernels launched and kept, the
windows that kept all 20, those that kept none, and the mean device ms of a
kernel over the windows that kept all. One JSON line.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

REPS = 20


def _window(prof, fn, tag: str, new: bool, skip: int) -> tuple:
    """(the device events of REPS calls of fn after the marker `tag`, the
    profiler's event count). skip: the events of earlier windows, which an
    acc_events profiler keeps (their times count from their own window's
    start, so only their place in the list tells them apart)."""
    from torch.autograd import DeviceType
    from torch.profiler import record_function
    if new:
        prof.__enter__()
    else:
        prof.start()
    fn()
    torch.cuda.synchronize()
    with record_function(tag):
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    if new:
        prof.__exit__(None, None, None)
    else:
        prof.stop()
    events = list(prof.events())
    mine = events[skip:]
    marks = [e.time_range for e in mine
             if e.name == tag and e.device_type == DeviceType.CPU]
    if not marks:
        return [], len(events)
    return [e for e in mine if e.device_type == DeviceType.CUDA
            and "route_gather" in e.name
            and e.time_range.start >= marks[0].start], len(events)


def main(argv=None) -> int:
    from torch.profiler import ProfilerActivity, profile
    from ..ops.cuda import route_gather as rg
    p = argparse.ArgumentParser(prog="exp_profiler")
    p.add_argument("--windows", type=int, default=30)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("exp_profiler: no CUDA device", file=sys.stderr)
        return 1
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    g = torch.Generator().manual_seed(3)
    out = {"device": torch.cuda.get_device_name(0), "reps": REPS}
    for k in (18, 20):
        n = 1 << k
        idx = torch.randperm(n, generator=g).to(torch.int32).cuda()
        x = torch.arange(n, dtype=torch.int32, device="cuda")
        fn = lambda: rg.route_gather_finish(x, idx)  # noqa: E731
        fn()
        torch.cuda.synchronize()
        acc, acc_seen = profile(activities=acts, acc_events=True), 0
        stats = {w: dict(windows=0, launched=0, kept=0, full=0, empty=0,
                         ms=[]) for w in ("new", "acc")}
        for i in range(args.windows):
            for way in ("new", "acc") if i % 2 == 0 else ("acc", "new"):
                prof = profile(activities=acts) if way == "new" else acc
                dev, seen = _window(prof, fn, f"vgl_window_{k}_{i}_{way}",
                                    way == "new",
                                    acc_seen if way == "acc" else 0)
                if way == "acc":
                    acc_seen = seen
                st = stats[way]
                st["windows"] += 1
                st["launched"] += REPS
                st["kept"] += len(dev)
                st["full"] += len(dev) == REPS
                st["empty"] += not dev
                if len(dev) == REPS:
                    st["ms"].append(sum(e.time_range.elapsed_us()
                                        for e in dev) / REPS / 1e3)
        for st in stats.values():
            ms = st.pop("ms")
            st["mean_device_ms"] = sum(ms) / len(ms) if ms else None
        out[f"2^{k}"] = stats
        print(f"2^{k}: {json.dumps(stats)}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
