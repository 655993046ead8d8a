"""The port's own spans in a traced window, and the idle gaps they open.

The port names its spans vgl.<layer>... (vectorgraphlibrary_tpu_torch/
runtime/profiling.annotate) and records them on the profiler's host clock,
the clock of each device operation's launch; `trace.from_profiler` keeps
them among `Trace.host`. A gap in the device's work is put down to the
host by launch times alone: the launch of the operation whose end opens
the gap and the launch of the one whose start closes it, both on the host
clock, so that the drift of the device's clock over a window moves no
attribution. Only the gap's length is taken on the device's clock, from
`trace.idle_gaps`' union of device intervals. Nothing here reads an aten
event.

    python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s>

runs the cell as `portbench.run --trace 1` does, prints its result line,
then one JSON line: the idle seconds of the window by the innermost vgl.*
span that holds the launch closing each gap, the device seconds (all, and
torch.arange's) by the span that launched them, and every cudaMalloc in
the window with its innermost span.
"""
from __future__ import annotations

import re

import numpy as np

from .trace import Trace, idle_gaps, span_of

PREFIX = "vgl."
HOST_READ = "vgl.host_read"
# torch.arange's kernel on the card
ARANGE = "elementwise_kernel_with_index"


def vgl_spans(trace: Trace) -> tuple:
    """(names, starts, ends) of the port's spans, as numpy arrays sorted by
    start, an enclosing span before the spans it holds."""
    rows = [h for h in trace.host if h[0].startswith(PREFIX)]
    names = np.array([r[0] for r in rows], dtype=object)
    starts = np.array([r[1] for r in rows], dtype=float)
    ends = np.array([r[2] for r in rows], dtype=float)
    order = np.lexsort((-ends, starts))
    return names[order], starts[order], ends[order]


def _device(trace: Trace) -> tuple:
    """(starts, ends, launches) of the device operations; a row without a
    launch time is taken as launched at its start."""
    n = len(trace.device)
    starts = np.fromiter((r[1] for r in trace.device), float, n)
    ends = np.fromiter((r[2] for r in trace.device), float, n)
    launches = np.fromiter((r[3] if len(r) > 3 else r[1]
                            for r in trace.device), float, n)
    return starts, ends, launches


def gap_launches(trace: Trace) -> tuple:
    """(gap starts, gap ends, launch before, launch after) of the window's
    idle gaps that have a device operation on each side: the launch of the
    operation whose end opens the gap, and of the one whose start closes
    it. The gaps are `trace.idle_gaps`', longest first."""
    gaps = np.array(idle_gaps(trace), dtype=float).reshape(-1, 2)
    if not trace.device or not len(gaps):
        empty = np.empty(0)
        return empty, empty, empty, empty
    starts, ends, launches = _device(trace)
    by_end = np.argsort(ends, kind="stable")
    i = np.searchsorted(ends[by_end], gaps[:, 0], side="right") - 1
    by_start = np.argsort(starts, kind="stable")
    j = np.searchsorted(starts[by_start], gaps[:, 1], side="left")
    ok = (i >= 0) & (j < len(starts))
    i, j, gaps = by_end[i[ok]], by_start[j[ok]], gaps[ok]
    # the window's first and last gaps reach its edge, not an operation
    ok = (ends[i] == gaps[:, 0]) & (starts[j] == gaps[:, 1])
    return (gaps[ok, 0], gaps[ok, 1], launches[i[ok]], launches[j[ok]])


def host_read_idle_us(trace: Trace):
    """Microseconds of the window in gaps that a host read opened: gaps
    with some vgl.host_read span that ends after the launch before the gap
    and no later than the launch after it. None without vgl.* spans or
    device operations."""
    names, _, ends = vgl_spans(trace)
    if not len(names) or not trace.device:
        return None
    reads = np.sort(ends[names == HOST_READ])
    gs, ge, before, after = gap_launches(trace)
    hit = (np.searchsorted(reads, after, side="right")
           - np.searchsorted(reads, before, side="right")) > 0
    return float(np.sum((ge - gs)[hit]))


def host_read_idle_pct(trace: Trace):
    """100 x host_read_idle_us / the window, or None."""
    lo, hi = trace.window_us
    us = host_read_idle_us(trace)
    return None if us is None or hi <= lo else 100.0 * us / (hi - lo)


def host_reads_per_job(trace: Trace, kind: str):
    """vgl.host_read spans that start inside the job spans of `kind`, over
    those jobs. None when the trace holds no vgl.* span or no such job."""
    jobs = np.array([(s, e) for k, s, e in trace.spans if k == kind],
                    dtype=float).reshape(-1, 2)
    names, starts, _ = vgl_spans(trace)
    if not len(names) or not len(jobs):
        return None
    reads = starts[names == HOST_READ]      # sorted
    inside = (np.searchsorted(reads, jobs[:, 1], side="right")
              - np.searchsorted(reads, jobs[:, 0], side="left"))
    return float(inside.sum()) / len(jobs)


def innermost(starts, ends, times) -> np.ndarray:
    """For each time, the index of the innermost span (spans as
    `vgl_spans` sorts them, nested as the blocks of one thread) that holds
    it, or -1."""
    times = np.asarray(times, dtype=float)
    best = np.full(times.shape, -1)
    if not len(starts):
        return best
    # a span's depth: the spans before it in order, less those closed by
    # its start
    depth = np.arange(len(starts)) - np.searchsorted(np.sort(ends), starts,
                                                     side="right")
    for d in range(int(depth.max()) + 1):
        at = np.flatnonzero(depth == d)       # disjoint, sorted by start
        k = np.searchsorted(starts[at], times, side="right") - 1
        hit = k >= 0
        hit[hit] = times[hit] <= ends[at[k[hit]]]
        best[hit] = at[k[hit]]
    return best


def _where(trace: Trace, names, idx, t) -> str:
    if idx >= 0:
        return names[idx]
    return f"{span_of(trace, t) or 'between jobs'}: outside vgl spans"


def idle_by_span(trace: Trace) -> dict:
    """{span name: [idle seconds, gaps]} of the window's gaps, each named by
    the innermost vgl.* span that holds the launch of the operation closing
    it (else its job kind), largest first."""
    names, starts, ends = vgl_spans(trace)
    gs, ge, _, after = gap_launches(trace)
    out = {}
    for gap, t, i in zip(ge - gs, after, innermost(starts, ends, after)):
        row = out.setdefault(_where(trace, names, i, t), [0.0, 0])
        row[0] += gap / 1e6
        row[1] += 1
    return dict(sorted(out.items(), key=lambda kv: -kv[1][0]))


def device_by_span(trace: Trace, pattern: str = "") -> dict:
    """{span name: device seconds} of the device operations whose name
    matches the regular expression `pattern`, each put in the innermost
    vgl.* span that holds its launch (else its job kind), largest first."""
    rx = re.compile(pattern)
    rows = [r for r in trace.device if rx.search(r[0])]
    names, starts, ends = vgl_spans(trace)
    t = [r[3] if len(r) > 3 else r[1] for r in rows]
    out = {}
    for r, ti, i in zip(rows, t, innermost(starts, ends, t)):
        key = _where(trace, names, i, ti)
        out[key] = out.get(key, 0.0) + (r[2] - r[1]) / 1e6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def mallocs(trace: Trace) -> list:
    """[(innermost vgl.* span, milliseconds)] of each cudaMalloc the host
    called inside the window."""
    lo, hi = trace.window_us
    rows = [h for h in trace.host
            if h[0] == "cudaMalloc" and lo <= h[1] <= hi]
    names, starts, ends = vgl_spans(trace)
    t = [r[1] for r in rows]
    return [(_where(trace, names, i, ti), (r[2] - r[1]) / 1e3)
            for r, ti, i in zip(rows, t, innermost(starts, ends, t))]


def phase_s(kept: list, phase: str):
    """Seconds of the kept spans named `phase` ([(name, start_s, end_s)])
    inside the last kept vgl.import span, or None without such spans."""
    imports = [(s, e) for n, s, e in kept if n == "vgl.import"]
    if not imports:
        return None
    lo, hi = imports[-1]
    inside = [e - s for n, s, e in kept if n == phase and lo <= s <= e <= hi]
    return float(sum(inside)) if inside else None


def import_phase_s(phase: str):
    """phase_s of the port's kept spans in this process, or None where the
    port keeps none (runtime/profiling.kept_spans)."""
    try:
        from vectorgraphlibrary_tpu_torch.runtime.profiling import \
            kept_spans
    except ImportError:
        return None
    return phase_s(kept_spans(), phase)


def main(argv=None) -> int:
    import json
    import time
    from pathlib import Path

    from . import harness
    from .run import parser

    args = parser().parse_args(argv)
    # run_cell hands its traced Run only to per_layer: keep it on the way
    runs = []
    per_layer = harness.per_layer

    def keep(run):
        runs.append(run)
        return per_layer(run)

    harness.per_layer = keep
    try:
        result = harness.run_cell(Path.cwd(), args.workload, args.seed,
                                  args.seconds, True, "cuda")
    finally:
        harness.per_layer = per_layer
    print(json.dumps(result), flush=True)
    t = time.perf_counter()
    trace = runs[0].trace
    lo, hi = trace.window_us
    out = {"window_s": (hi - lo) / 1e6, "idle_by_span": idle_by_span(trace),
           "busy_by_span": device_by_span(trace),
           "arange_by_span": device_by_span(trace, ARANGE),
           "cuda_malloc": mallocs(trace)}
    out["seconds"] = time.perf_counter() - t
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
