"""Benchmark and verification harness over the port's apps (port of
apps/run_tests.py; reference `apps/run_tests.py:10-177` +
`apps/scripts/{settings,benchmarking_api,verification_api,export}.py`):

  --verify     run each app with -check -it 1 over a tier of graphs, parse
               the "error count:" contract, enforce per-run wall timeouts
  --benchmark  run each app with -it N, parse "AVG_PERF: X MTEPS"
  --scaling    the strong-scaling sweep (apps/scaling.py) over --devices
               rank counts at scale --scale, one row per rank count

Each app runs as `python -m vectorgraphlibrary_tpu_torch.apps.<app>` in its
own process, on the card, or with --cpu on the CPU (-dev cpu). Tiers: tiny
to xlarge (synthetic graphs; xlarge, RMAT-22, runs 3600 s per app unless
--timeout says otherwise) and real (the corpus's cached graphs, the two
bundled ones included; io/corpus.py). Results go to <out>.json and
<out>.csv, by default under .cache/torch_harness/ (gitignored).

    python -m vectorgraphlibrary_tpu_torch.apps.run_tests --verify --cpu
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

APPS = ["bfs", "pr", "sssp", "cc", "sswp", "hits", "coloring",
        "scc", "lp", "rw", "tc", "mf"]
# graph tiers (reference settings.py:90-157)
TIERS = {
    "tiny": [("rmat", 12, 16), ("ru", 12, 16)],
    "small": [("rmat", 14, 16), ("ru", 14, 16)],
    "medium": [("rmat", 18, 32)],
    "large": [("rmat", 20, 32)],
    # each app imports the graph itself (minutes of host preprocessing at
    # scale 22, in the tier's timeout); the scale-25 tier runs through the
    # persisted sharded artifact instead (apps/build_scale25.py,
    # apps/bench_scale25.py, apps/bench_s22w_resident.py)
    "xlarge": [("rmat", 22, 16)],
}
DEFAULT_TIMEOUT = 600
TIER_TIMEOUTS = {"xlarge": 3600}
DEFAULT_OUT = os.path.join(REPO, ".cache", "torch_harness", "harness_results")


def timeout_for(tier: str, timeout: int) -> int:
    """Seconds per app run: the tier's own (TIER_TIMEOUTS) unless --timeout
    names another than the default."""
    if timeout == DEFAULT_TIMEOUT and tier in TIER_TIMEOUTS:
        return TIER_TIMEOUTS[tier]
    return timeout


def run_app(app: str, args: list, timeout: int) -> tuple[str, float, bool]:
    """Returns (stdout + stderr, wall seconds, timed_out)."""
    cmd = [sys.executable, "-m", f"vectorgraphlibrary_tpu_torch.apps.{app}",
           *args]
    t0 = time.time()
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout, cwd=REPO)
        return r.stdout + r.stderr, time.time() - t0, False
    except subprocess.TimeoutExpired as te:
        out = te.stdout or ""
        if isinstance(out, bytes):
            out = out.decode()
        return out, time.time() - t0, True


def parse_error_count(out: str):
    errs = [int(line.split("error count:")[1])
            for line in out.splitlines() if "error count:" in line]
    return max(errs) if errs else None


def parse_avg_perf(out: str):
    for line in out.splitlines():
        if line.startswith("AVG_PERF:"):
            return float(line.split()[1])
    return None


def graph_args(kind, scale, degree):
    if kind == "load":                      # real-graph corpus entry
        return ["-load", scale]             # scale slot carries the path
    base = ["-s", str(scale), "-e", str(degree)]
    return base + (["-ru"] if kind == "ru" else [])


def real_graph_corpus(names=None):
    """The corpus's cached graphs as ('load', path, name) rows, the bundled
    real graphs converted first (reference real-graph tiers,
    settings.py:52-86)."""
    from ..io import corpus
    for name in corpus.BUNDLED:
        corpus.bundled_graph(name)
    d = corpus.graph_dir()
    rows = [("load", os.path.join(d, f), f[:-len(".el_container")])
            for f in sorted(os.listdir(d)) if f.endswith(".el_container")]
    if names:
        rows = [r for r in rows if r[2] in names]
    if not rows:
        print(f"real tier: no cached corpus graphs under {d}")
    return rows


def _label(kind, scale, degree):
    """A row's graph name (a corpus row carries it in the degree slot)."""
    return degree if kind == "load" else f"{kind}-{scale}"


def do_verify(apps, graphs, timeout, extra):
    rows = []
    ok = True
    for app in apps:
        for kind, scale, degree in graphs:
            out, wall, to = run_app(
                app, graph_args(kind, scale, degree)
                + ["-check", "-it", "1", *extra], timeout)
            err = parse_error_count(out)
            status = ("TIMED OUT" if to else
                      "ERROR" if err is None else
                      "PASS" if err == 0 else f"FAIL({err})")
            ok &= status == "PASS"
            graph = _label(kind, scale, degree)
            print(f"verify {app:10s} {graph}: {status} ({wall:.1f}s)")
            rows.append(dict(mode="verify", app=app, graph=graph,
                             status=status, wall_s=round(wall, 1)))
    return rows, ok


def do_benchmark(apps, graphs, timeout, iters, extra):
    rows = []
    for app in apps:
        for kind, scale, degree in graphs:
            out, wall, to = run_app(
                app, graph_args(kind, scale, degree) + ["-it", str(iters),
                                                        *extra], timeout)
            perf = None if to else parse_avg_perf(out)
            graph = _label(kind, scale, degree)
            print(f"bench {app:10s} {graph}: "
                  f"{'TIMED OUT' if to else f'{perf} MTEPS'} ({wall:.1f}s)")
            rows.append(dict(mode="benchmark", app=app, graph=graph,
                             mteps=perf, wall_s=round(wall, 1)))
    return rows


def do_scaling(devices: str, scale: int, iters: int, cpu: bool,
               timeout: int):
    """apps/scaling.py's sweep (reference run_tests.py:197-203): its JSON
    line's rows, or one row that says why there are none."""
    out, wall, to = run_app(
        "scaling", ["--devices", devices, "-s", str(scale), "--iters",
                    str(iters)] + (["--cpu"] if cpu else []), timeout)
    res = None
    if not to and out.strip():
        try:
            res = json.loads(out.strip().splitlines()[-1])
        except json.JSONDecodeError:
            res = None
    status = "TIMED OUT" if to else "ERROR" if res is None else "PASS"
    print(f"scaling {devices} at scale {scale}: {status} ({wall:.1f}s)")
    if res is None:
        print(out[-2000:])
        return [dict(mode="scaling", status=status, wall_s=round(wall, 1))]
    return [dict(mode="scaling", status=status, device=res["device"],
                 wall_s=round(wall, 1), **r) for r in res["results"]]


def export(rows, path_base):
    os.makedirs(os.path.dirname(os.path.abspath(path_base)), exist_ok=True)
    with open(path_base + ".json", "w") as f:
        json.dump(rows, f, indent=1)
    if rows:
        with open(path_base + ".csv", "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=sorted({k for r in rows for k in r}))
            w.writeheader()
            w.writerows(rows)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="run_tests")
    p.add_argument("--verify", action="store_true")
    p.add_argument("--benchmark", action="store_true")
    p.add_argument("--scaling", action="store_true",
                   help="strong-scaling sweep over --devices rank counts")
    p.add_argument("--devices", default="1,2,4,8",
                   help="--scaling's rank counts")
    p.add_argument("--scale", type=int, default=14, help="--scaling's scale")
    p.add_argument("--tier", default="tiny", choices=list(TIERS) + ["real"])
    p.add_argument("--apps", default=None, help="comma-separated subset")
    p.add_argument("--timeout", type=int, default=DEFAULT_TIMEOUT)
    p.add_argument("--it", type=int, default=10)
    p.add_argument("--cpu", action="store_true",
                   help="run the apps on the CPU (-dev cpu)")
    p.add_argument("--real", default=None,
                   help="comma-separated real-graph names for --tier real")
    p.add_argument("--out", default=DEFAULT_OUT,
                   help="results go to OUT.json and OUT.csv")
    args = p.parse_args(argv)
    args.timeout = timeout_for(args.tier, args.timeout)
    apps = args.apps.split(",") if args.apps else APPS
    graphs = (real_graph_corpus(args.real.split(",") if args.real else None)
              if args.tier == "real" else TIERS[args.tier])
    extra = ["-dev", "cpu"] if args.cpu else []
    rows = []
    ok = True
    if args.verify:
        r, ok = do_verify(apps, graphs, args.timeout, extra)
        rows += r
    if args.benchmark:
        rows += do_benchmark(apps, graphs, args.timeout, args.it, extra)
    if args.scaling:
        r = do_scaling(args.devices, args.scale, args.it, args.cpu,
                       args.timeout)
        ok &= all(row["status"] == "PASS" for row in r)
        rows += r
    export(rows, args.out)
    print(f"results written to {args.out}.json/.csv")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
