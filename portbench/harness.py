"""One run of one cell: set-up, the measured window, the check, the line.

Set-up: the configuration's graph (and, where a job kind needs them, its
weights and roots) drawn on the card, relabelled by a permutation drawn
from the seed, and copied to the host once (`_draw`); the port's
graph/device.import_graph(build_route=False) and, for weights,
graph/edges.build_edge_array_from_host; the kernel library
loaded from .cache/torch_kernels/ in the checkout (built there by the
first run); a few jobs of each kind as warm-up.

Window: one client in a closed loop runs the mix's job kinds in turn, each
job ended by a synchronize, until --seconds have passed; the round of
kinds that crosses the limit is finished and ends the window. Each kind's
rate is its jobs' work over the host-clock time of its jobs, which
together fill the window.

Check: a sample of each kind's jobs, drawn from the seed by reservoir
sampling over the window, is put in original vertex order; then the
program's state is freed and the plain reference of each kind (ref/) runs
on the card from the same edge list and weights, and judges them.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import pkgutil
import random
import subprocess
import sys
import time
from typing import Optional

import torch

from .cell import Cell, load_cell
from .trace import SPAN_PREFIX, Trace, from_profiler, busy_us, breakdown

PORT = "vectorgraphlibrary_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "vectorgraphlibrary_tpu")


@dataclasses.dataclass
class Job:
    kind: str
    seconds: float
    work: int
    counters: Optional[dict] = None     # launches by wrapper (traced runs)


@dataclasses.dataclass
class Run:
    """What the end-to-end arithmetic and the per-layer readers see."""

    cell: Cell
    device_kind: str
    v: int
    e: int
    v_pad: int
    setup: dict                 # seconds by set-up phase
    jobs: list                  # [Job] of the window, in order
    window_s: float
    trace: Optional[Trace] = None


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: the port's name begins with the JAX
    package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def smi() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi not read: {exc}"


def launch_counters() -> dict:
    """Every kernel wrapper of the port's ops/cuda that counts its
    launches: {wrapper name: its function}."""
    pkg = importlib.import_module(f"{PORT}.ops.cuda")
    found = {}
    for info in pkgutil.iter_modules(pkg.__path__):
        mod = importlib.import_module(f"{pkg.__name__}.{info.name}")
        for name, obj in vars(mod).items():
            if callable(obj) and isinstance(getattr(obj, "launches", None),
                                            int):
                found[name] = obj
    return found


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _draw(cell: Cell, seed: int, device: torch.device, log) -> dict:
    """The seeded inputs on the host: src, dst (int32 numpy), v, weights
    (float32 numpy or None), roots (list).

    The configuration's generator draws one graph from its `graph_seed`,
    with its weights from graph_seed + 1. `seed` relabels its vertices by a
    random permutation and reorders its edges, each weight travelling with
    its edge, and draws the roots (seed + 1): every seed runs an isomorphic
    graph, the same work in another order."""
    jobs = [cell.job(k) for k in cell.kinds]
    t = time.perf_counter()
    graph_seed = int(cell.config["graph_seed"])
    src, dst, v = cell.generator().edges(cell.config["params"], graph_seed,
                                         device)
    weights = roots = None
    if any(j.NEEDS_WEIGHTS for j in jobs):
        low, high = cell.config["weights"]["low"], \
            cell.config["weights"]["high"]
        gen = torch.Generator(device=device)
        gen.manual_seed(graph_seed + 1)
        weights = torch.rand(src.numel(), generator=gen, device=device) \
            * (high - low) + low
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    label = torch.randperm(v, generator=gen, device=device).to(torch.int32)
    order = torch.randperm(src.numel(), generator=gen, device=device)
    src, dst = label[src.long()][order], label[dst.long()][order]
    if weights is not None:
        weights = weights[order]
    del label, order
    if any(j.NEEDS_ROOTS for j in jobs):
        # the Graph500 rule: roots among vertices of out-degree >= 1
        cand = torch.nonzero(torch.bincount(src, minlength=v) > 0).flatten()
        gen = torch.Generator(device=device)
        gen.manual_seed(seed + 1)
        pick = torch.randint(0, cand.numel(), (int(cell.mix["roots"]),),
                             generator=gen, device=device)
        roots = cand[pick].tolist()
    _sync(device)
    gen_s = time.perf_counter() - t
    t = time.perf_counter()
    out = dict(src=src.cpu().numpy(), dst=dst.cpu().numpy(), v=v,
               weights=None if weights is None else weights.cpu().numpy(),
               roots=roots)
    out["setup"] = {"generate_s": gen_s,
                    "host_copy_s": time.perf_counter() - t}
    log(f"drew {cell.config_name} (graph seed {graph_seed}) for seed {seed}: "
        f"|V|={v:,} |E|={src.numel():,} in {gen_s:.3f} s, host copy "
        f"{out['setup']['host_copy_s']:.3f} s")
    return out


def _import(data: dict, device: torch.device) -> tuple:
    """(graph, edge weights or None, import seconds): the port's import."""
    from vectorgraphlibrary_tpu_torch.graph.device import import_graph
    from vectorgraphlibrary_tpu_torch.graph.edges import \
        build_edge_array_from_host
    from vectorgraphlibrary_tpu_torch.io.edges_container import \
        EdgesContainer
    t = time.perf_counter()
    ec = EdgesContainer(data["src"], data["dst"], data["v"])
    host = []
    graph = import_graph(ec, device=device, _host_out=host,
                         build_route=False)
    ea = None
    if data["weights"] is not None:
        ea = build_edge_array_from_host(data["weights"], graph, host[0],
                                        host[1])
    del host, ec
    _sync(device)
    return graph, ea, time.perf_counter() - t


def _original(graph, arr) -> torch.Tensor:
    """A job's VertexArray in original vertex order, [v], on the host."""
    from vectorgraphlibrary_tpu_torch.config import TraversalDirection as D
    vals = arr.values
    if arr.direction == D.ORIGINAL:
        return vals[:graph.v].cpu()
    dg = graph.outgoing if arr.direction == D.SCATTER else graph.incoming
    return vals[dg.orig_to_sorted[:graph.v].long()].cpu()


class _Reservoir:
    """k items drawn uniformly from a stream, from a seeded generator."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng, self.n, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.n + 1)
            if j < self.k:
                self.items[j] = item
        self.n += 1


def _window(cell: Cell, graph, ea, data: dict, entries: dict, seconds: float,
            seed: int, device: torch.device, traced: bool, log) -> tuple:
    """The closed loop: ([Job], window seconds, {kind: [(root, output)]},
    Trace or None)."""
    counters = launch_counters() if traced else {}
    rng = random.Random(seed)
    samples = {k: _Reservoir(int(cell.mix["checked_per_kind"]), rng)
               for k in cell.kinds}
    works = {k: cell.job(k).work(graph.v, graph.e, cell.params(k))
             for k in cell.kinds}
    roots, n_roots = data["roots"], len(data["roots"] or [])
    jobs, count = [], {k: 0 for k in cell.kinds}
    prof = None
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    _sync(device)
    t0 = last = time.perf_counter()
    deadline = t0 + seconds
    i = 0
    while True:
        kind = cell.kinds[i % len(cell.kinds)]
        root = roots[count[kind] % n_roots] if n_roots else None
        before = {n: f.launches for n, f in counters.items()}
        if traced:
            with torch.profiler.record_function(SPAN_PREFIX + kind):
                out = entries[kind](graph, ea, root)
                _sync(device)
        else:
            out = entries[kind](graph, ea, root)
            _sync(device)
        now = time.perf_counter()
        delta = {n: f.launches - before[n] for n, f in counters.items()
                 if f.launches != before[n]} if traced else None
        jobs.append(Job(kind, now - last, works[kind], delta))
        samples[kind].offer((root, out))
        count[kind] += 1
        last = now
        i += 1
        if now >= deadline and i % len(cell.kinds) == 0:
            break
    trace = None
    if prof is not None:
        t = time.perf_counter()
        prof.stop()
        stop_s = time.perf_counter() - t
        trace = from_profiler(prof)
        del prof
        log(f"trace: profiler stopped in {stop_s:.1f} s, read in "
            f"{time.perf_counter() - t - stop_s:.1f} s: "
            f"{len(trace.device):,} device and {len(trace.host):,} host "
            f"operations, {sum(r[3] != r[1] for r in trace.device):,} "
            f"device operations placed by their launch")
    return jobs, last - t0, {k: s.items for k, s in samples.items()}, trace


def end_to_end(run: Run) -> dict:
    """The cell's end-to-end metrics: setup_s, and each job kind's rate,
    its jobs' work over their time."""
    out = {}
    for m in run.cell.end_to_end:
        if m["name"] == "setup_s":
            value = run.setup["setup_s"]
        else:
            kinds = [k for k in run.cell.kinds
                     if run.cell.job(k).METRIC == m["name"]]
            if not kinds:
                raise KeyError(f"no job kind of mix {run.cell.mix_name} "
                               f"gives {m['name']}")
            mine = [j for j in run.jobs if j.kind in kinds]
            per = run.cell.job(kinds[0]).PER_UNIT
            value = sum(j.work for j in mine) / sum(j.seconds
                                                    for j in mine) / per
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def per_layer(run: Run) -> dict:
    """The cell's per-layer metrics, each from its reader; a reader that
    finds nothing returns None and the metric is left out."""
    out = {}
    for m in run.cell.per_layer:
        value = run.cell.metric_reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def _check(cell: Cell, data: dict, got: dict, device: torch.device,
           log) -> tuple:
    """Each sampled answer against the plain reference: (checks {name:
    {"value": worst, "limit": limit}}, answers judged, answers failed)."""
    src = torch.from_numpy(data["src"]).to(device)
    dst = torch.from_numpy(data["dst"]).to(device)
    w = None if data["weights"] is None \
        else torch.from_numpy(data["weights"]).to(device)
    checks, judged, failed = {}, 0, 0
    for kind, answers in got.items():
        ref = cell.ref(kind)
        params = cell.params(kind)
        for name, limit in ref.LIMITS.items():
            checks.setdefault(name, {"value": 0.0, "limit": limit})
        wants = {}
        for root, answer in answers:
            if root not in wants:
                wants[root] = ref.solve(src, dst, w, data["v"], root, params)
            values = ref.compare(answer, wants[root])
            judged += 1
            bad = False
            for name, value in values.items():
                c = checks[name]
                c["value"] = max(c["value"], value)
                bad |= not value <= c["limit"]
            failed += bad
            log(f"checked {kind} root={root}: {values}")
    return checks, judged, failed


def run_cell(root, workload: str, seed: int, seconds: float, traced: bool,
             device="cuda", t_start: Optional[float] = None,
             entries: Optional[dict] = None, log=None) -> dict:
    """Run `workload` of <root>/BENCHMARK.json once on `device` and return
    the result line's object (without the card checks of run.py).
    entries: {kind: run(graph, weights, root)} in place of the job kinds'
    own (the tests break the timed path this way)."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    device = torch.device(device)
    cell = load_cell(root, workload)
    data = _draw(cell, seed, device, log)
    setup = dict(data.pop("setup"))
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    graph, ea, setup["import_s"] = _import(data, device)
    log(f"imported: v_pad={graph.v_pad:,} in {setup['import_s']:.3f} s")
    t = time.perf_counter()
    if device.type == "cuda":
        from vectorgraphlibrary_tpu_torch.ops.cuda import build
        build.load_library()
        log(f"kernel library: built in {build.build_seconds:.1f} s"
            if build.build_seconds else "kernel library: found built")
    setup["kernels_s"] = time.perf_counter() - t
    entries = dict(entries or {})
    for kind in cell.kinds:
        entries.setdefault(kind, cell.job(kind).entry(cell.params(kind)))
    t = time.perf_counter()
    roots = data["roots"] or [None]
    for kind in cell.kinds:
        for i in range(int(cell.mix["warmup_per_kind"])):
            entries[kind](graph, ea, roots[-1 - i % len(roots)])
    _sync(device)
    setup["warmup_s"] = time.perf_counter() - t
    setup["setup_s"] = time.perf_counter() - t_start
    log("set-up: " + ", ".join(f"{k} {v:.3f}" for k, v in setup.items()))

    jobs, window_s, samples, trace = _window(
        cell, graph, ea, data, entries, seconds, seed, device, traced, log)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    kind_name = torch.cuda.get_device_name(device) \
        if device.type == "cuda" else "cpu"
    run = Run(cell=cell, device_kind=kind_name, v=graph.v, e=graph.e,
              v_pad=graph.v_pad, setup=setup, jobs=jobs, window_s=window_s,
              trace=trace)
    got = {k: [(r, _original(graph, out)) for r, out in items]
           for k, items in samples.items()}
    del graph, ea, samples, entries
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    metrics = per_layer(run) if traced else end_to_end(run)
    if traced:
        log(f"per-layer readers {time.perf_counter() - t:.1f} s")
    per_kind = {k: sum(1 for j in jobs if j.kind == k) for k in cell.kinds}
    log(f"window {window_s:.3f} s: jobs {per_kind}")
    t = time.perf_counter()
    checks, judged, failed = _check(cell, data, got, device, log)
    log(f"reference and check {time.perf_counter() - t:.3f} s, "
        f"{judged} answers, {failed} failed")
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": kind_name, "count": cell.chips,
           "memory_peak_bytes": int(peak)}
    result = {"correct": failed == 0 and judged > 0, "attempted": len(jobs),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace is not None and trace.spans:
        lo, hi = trace.window_us
        dev["busy_s"] = busy_us(trace) / 1e6
        dev["window_s"] = (hi - lo) / 1e6
        t = time.perf_counter()
        result["breakdown"] = breakdown(trace)
        log(f"breakdown {time.perf_counter() - t:.1f} s")
    result["jobs"] = per_kind
    result["setup"] = setup
    result["checks"] = checks
    return result
