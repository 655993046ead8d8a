"""A traced window reduced to plain intervals, and the arithmetic on them.

The harness wraps every job of the window in a torch.profiler
record_function span named "job:<kind>" and synchronises before the span
ends, so every device operation of a job starts and ends inside its span.
`from_profiler` keeps, on the profiler's one clock (microseconds):

- spans: (kind, start, end) of the jobs, in order;
- device: (name, start, end, launch) of every kernel, copy and set on the
  card, launch being the host time of the call that launched it;
- host: (name, start, end) of every host operation other than the spans.

The functions below take a Trace and compute busy time, idle gaps and
device time per span and kernel name; they are plain arithmetic, tested on
hand-made traces.
"""
from __future__ import annotations

import dataclasses
import re

import numpy as np

SPAN_PREFIX = "job:"


@dataclasses.dataclass
class Trace:
    spans: list            # [(kind, start_us, end_us)], in order
    device: list           # [(name, start_us, end_us, launch_us)]
    host: list             # [(name, start_us, end_us)]

    @property
    def window_us(self) -> tuple:
        return (self.spans[0][1], self.spans[-1][2]) if self.spans \
            else (0.0, 0.0)


def from_profiler(prof) -> Trace:
    """The Trace of a finished torch.profiler.profile, read from its raw
    events (torch's own parse of them into a tree takes minutes for the
    millions of events of a window).

    A device operation is placed in a span by the host time of the call
    that launched it: the CUDA runtime call of the same correlation id, or
    else the host operation it is linked to. The device's clock is only
    aligned to the host's by an estimate that drifts over a long window,
    so its own start can fall outside the span that launched it."""
    from torch.autograd import DeviceType
    spans, device, host = [], [], []
    runtime, ops = {}, {}
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start = ev.start_ns() / 1e3
        end = start + ev.duration_ns() / 1e3
        if ev.device_type() == DeviceType.CUDA:
            if not name.startswith(SPAN_PREFIX):
                # (the span's mirror on the device's timeline is no
                # operation)
                device.append((name, start, end, ev.correlation_id(),
                               ev.linked_correlation_id()))
            continue
        (runtime if name.startswith("cuda") else ops)[
            ev.correlation_id()] = start
        if name.startswith(SPAN_PREFIX):
            spans.append((name[len(SPAN_PREFIX):], start, end))
        else:
            host.append((name, start, end))
    device = [(name, s, e, runtime.get(corr, ops.get(linked, s)))
              for name, s, e, corr, linked in device]
    spans.sort(key=lambda s: s[1])
    return Trace(spans=spans, device=device, host=host)


def _union(intervals) -> list:
    """Sorted, merged [start, end] intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _clip(trace: Trace) -> list:
    lo, hi = trace.window_us
    return [(max(r[1], lo), min(r[2], hi)) for r in trace.device
            if r[2] > lo and r[1] < hi]


def busy_us(trace: Trace) -> float:
    """Microseconds of the window in which some device operation ran."""
    return sum(e - s for s, e in _union(_clip(trace)))


def idle_gaps(trace: Trace) -> list:
    """[(start, end)] of the window with no device operation, longest
    first."""
    lo, hi = trace.window_us
    gaps, t = [], lo
    for s, e in _union(_clip(trace)):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return sorted(gaps, key=lambda g: g[0] - g[1])


def span_of(trace: Trace, t: float):
    """The kind of the span that holds time t, or None."""
    starts = np.array([s for _, s, _ in trace.spans])
    i = int(np.searchsorted(starts, t, side="right")) - 1
    if i >= 0 and t <= trace.spans[i][2]:
        return trace.spans[i][0]
    return None


def device_in_spans(trace: Trace, kind: str, pattern: str = "") -> tuple:
    """(microseconds, count) of the device operations whose name matches
    the regular expression `pattern` and that were launched inside a span
    of `kind` (a row without a launch time counts by its start)."""
    spans = [(s, e) for k, s, e in trace.spans if k == kind]
    if not spans:
        return 0.0, 0
    starts = np.array([s for s, _ in spans])
    ends = np.array([e for _, e in spans])
    rx = re.compile(pattern)
    total, count = 0.0, 0
    for row in trace.device:
        name, s, e = row[:3]
        t = row[3] if len(row) > 3 else s
        i = int(np.searchsorted(starts, t, side="right")) - 1
        if i >= 0 and t <= ends[i] and rx.search(name):
            total += e - s
            count += 1
    return total, count


def _host_at(trace: Trace, times) -> list:
    """For each time, the shortest host operation that spans it, or
    "python"."""
    if not trace.host:
        return ["python"] * len(times)
    s = np.array([h[1] for h in trace.host])
    e = np.array([h[2] for h in trace.host])
    out = []
    for t in times:
        hit = np.flatnonzero((s <= t) & (t <= e))
        out.append(trace.host[hit[np.argmin(e[hit] - s[hit])]][0]
                   if hit.size else "python")
    return out


def breakdown(trace: Trace, top: int = 10, name_chars: int = 120) -> dict:
    """The result line's breakdown: the device operations that took most time
    ([name, seconds], summed by name), and the longest idle gaps, each
    named by the job span it falls in and the host operation running at
    its middle ([name, seconds])."""
    by_name = {}
    for name, s, e, *_ in trace.device:
        key = name[:name_chars]
        by_name[key] = by_name.get(key, 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    longest = idle_gaps(trace)[:top]
    mids = [(s + e) / 2 for s, e in longest]
    gaps = [[f"{span_of(trace, m) or 'between jobs'}: {op[:name_chars]}",
             (e - s) / 1e6]
            for (s, e), m, op in zip(longest, mids, _host_at(trace, mids))]
    return {"device_ops": [list(kv) for kv in ops], "idle_gaps": gaps}


def idle_pct(trace: Trace):
    """100 x (1 - busy / window): the device's idle share of the window,
    or None for a trace with no device operation."""
    lo, hi = trace.window_us
    if not trace.device or hi <= lo:
        return None
    return 100.0 * (1.0 - busy_us(trace) / (hi - lo))
