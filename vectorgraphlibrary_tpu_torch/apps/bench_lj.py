"""SSSP, CC and MS-BFS on the LiveJournal-scale replica (the port's
counterpart of apps/bench_lj.py): BASELINE.md's "SSSP + CC on
soc-LiveJournal, single chip, verified results" on `lj-replica`
(apps/make_lj_replica.py: 4,847,571 vertices, 68,993,773 edges).

    python -m vectorgraphlibrary_tpu_torch.apps.bench_lj [-dev cuda] [-check] [sssp cc msbfs]

The graph is read from {io.corpus.graph_dir()}/lj-replica.el_container
and given weights in [1, 100) from seed 7 where the file has none, as the
JAX script does. A first row gives the import's seconds (import_graph
and build_edge_array_from_host, weights included), whether it built the
advance route (it does not: no row reads it) and the bytes on the device.
The rows (a subset where named), under the JAX script's metric names and
by its formulas:

- sssp_lj-replica_mteps: vgl_dijkstra_multi from 8 sources
  (select_random_source seeds 100-107; the warm-up 0-7), |E| * 8 / t.
  Above 2^22 edges it takes the partial-active path: weighted pull_reduce
  sweeps and the sparse push through scatter_combine. Each source's
  reached vertices;
- cc_lj-replica_mteps: vgl_cc_hybrid_multi from 4 hubs (the second 4
  draws of np.random.default_rng(3) over the vertices; the warm-up the
  first 4), |E| * 4 / t; the first run's component count (torch.unique,
  outside the timed window);
- bfs_msbfs_lj-replica_gteps: vgl_msbfs from 64 roots (seeds 300-363;
  the warm-up 0-63: two 32-root words each), the roots' traversed edges
  / t: each root's reached vertices' out-degrees (every edge, repeats and
  self-loops included, as the graph's outgoing degrees count them),
  summed exactly in int64 outside the timed window; the or-pulls of the
  warm-up and of a timed call.

Each row is timed by runtime/timer.DeviceTimer over 3 calls after a
warm-up call: t is their median, and the row keeps their seconds, min and
max and the card's peak allocated bytes over them. -check runs the host
oracle (apps/exp_lj_oracle.py) on the same graph and seeds and holds the
last timed call of each row to it: each hub's labels to scipy's weak
components up to relabelling, each root's reached set and traversed
edges exactly, each source's distances at utils/verify's tolerance; its
row says where they differ, and the app exits 1 if any does. One JSON
line per row on stdout, with the card's name and power limit; nothing is
written to a file (the JAX script writes BENCH_LJ.json; this app leaves
it alone). Exits 1, with a JSON note, when the graph file is missing.
-dev cpu runs the same on the CPU (the tests' size).
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time

import numpy as np
import torch

from .make_lj_replica import NAME
from .scale_tier import (device_label, emit, log, smi, tensor_bytes,
                         timed_call, traversed_per_root)

ROWS = ("sssp", "cc", "msbfs")
WEIGHT_SEED = 7
N_SOURCES, N_HUBS, N_ROOTS = 8, 4, 64
SOURCE_SEED, ROOT_SEED, HUB_SEED = 100, 300, 3
REPS = 3


def _seeded(deg: np.ndarray, n: int, first: int) -> list:
    from ..models import common
    return [common.select_random_source(deg, seed=first + s)
            for s in range(n)]


def sources(deg: np.ndarray) -> tuple:
    """SSSP's (warm-up, timed) sources: non-isolated vertices from seeds
    0-7 and 100-107 (deg: the out-degrees)."""
    return _seeded(deg, N_SOURCES, 0), _seeded(deg, N_SOURCES, SOURCE_SEED)


def roots(deg: np.ndarray) -> tuple:
    """MS-BFS's (warm-up, timed) roots: seeds 0-63 and 300-363."""
    return _seeded(deg, N_ROOTS, 0), _seeded(deg, N_ROOTS, ROOT_SEED)


def hubs(v: int) -> tuple:
    """CC's (warm-up, timed) hubs: two draws of 4 from default_rng(3)."""
    rng = np.random.default_rng(HUB_SEED)
    return (rng.integers(0, v, N_HUBS).tolist(),
            rng.integers(0, v, N_HUBS).tolist())


def out_degrees(ec) -> np.ndarray:
    return np.bincount(ec.src_ids, minlength=ec.vertices_count)


def _base(ec, device: torch.device) -> dict:
    base = {"graph": NAME, "v": ec.vertices_count, "e": ec.edges_count,
            "device": device_label(device)}
    if device.type == "cuda":
        base["nvidia_smi"] = smi()
    return base


def load(ec, device="cuda"):
    """ec imported onto `device` with its weights (seed 7 where it has
    none): (the weighted container, the graph, its EdgeArray, the import's
    row)."""
    from ..graph.device import import_graph
    from ..graph.edges import build_edge_array_from_host
    device = torch.device(device)
    t0 = time.perf_counter()
    if ec.weights is None:
        ec = ec.with_random_weights(WEIGHT_SEED)
    host = []
    graph = import_graph(ec, device=device, _host_out=host,
                         build_route=False)
    ea = build_edge_array_from_host(ec.weights, graph, host[0], host[1])
    del host
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    load_s = time.perf_counter() - t0
    log(f"imported {NAME}: |V|={graph.v:,} |E|={graph.e:,} ({load_s:.1f} s)")
    return ec, graph, ea, emit(dict(
        metric="import", value=load_s, unit="s",
        advance_route=graph.advance_route is not None,
        graph_bytes=tensor_bytes(graph), weight_bytes=tensor_bytes(ea),
        v_pad=graph.v_pad, **_base(ec, device)))


def msbfs_pulls(levels: torch.Tensor) -> int:
    """The or-pulls that the vgl_msbfs call which returned `levels` ([k,
    v_pad]) ran: each 32-root word pulls once per level its deepest root
    reached (the last pull finds nothing new); a short last word is padded
    with root 0, as vgl_msbfs pads it."""
    k = levels.shape[0]
    rows = torch.zeros((k + 31) // 32 * 32, dtype=torch.long)
    rows[:k] = torch.arange(k)
    deepest = levels[rows.to(levels.device)].reshape(-1, 32 * levels.shape[1])
    return int(deepest.amax(1).sum())


def measure(ec, graph, ea, device, only=ROWS, results=None) -> list:
    """Emit the rows of `only` (module doc) on the imported graph (ec the
    weighted container it came from); -> the rows. results: a dict that
    receives each row's output of its last timed call, by row name."""
    from ..models import bfs, cc, sssp
    device = torch.device(device)
    e, v = graph.e, graph.v
    deg = out_degrees(ec)
    base = _base(ec, device)
    results = {} if results is None else results
    rows = []

    def timed(name, warm, fn):
        """warm(), then fn() REPS times; -> (the last output, the median
        seconds, the fields every row keeps)."""
        warm()
        times, peaks = [], []
        for _ in range(REPS):
            out, seconds, peak = timed_call(device, fn)
            times.append(seconds)
            peaks.append(peak)
        results[name] = out
        t = statistics.median(times)
        return out, t, dict(
            seconds=t, seconds_min=min(times), seconds_max=max(times),
            peak_device_bytes=None if peaks[0] is None else max(peaks))

    def row(metric, value, unit, fields, **extra):
        rows.append(emit(dict(metric=metric, value=value, unit=unit,
                              **fields, **extra, **base)))

    if "sssp" in only:
        warm, srcs = sources(deg)
        dist, t, f = timed(
            "sssp", lambda: sssp.vgl_dijkstra_multi(graph, ea, warm).values,
            lambda: sssp.vgl_dijkstra_multi(graph, ea, srcs).values)
        row(f"sssp_{NAME}_mteps", e * N_SOURCES / t / 1e6, "MTEPS", f,
            sources=N_SOURCES, source_ids=srcs,
            partial_active=e >= sssp._AA_EDGE_THRESHOLD,
            reached=[int(n) for n in torch.isfinite(dist).sum(1)])
    if "cc" in only:
        warm, hs = hubs(v)
        labels, t, f = timed(
            "cc", lambda: cc.vgl_cc_hybrid_multi(graph, warm).values,
            lambda: cc.vgl_cc_hybrid_multi(graph, hs).values)
        row(f"cc_{NAME}_mteps", e * N_HUBS / t / 1e6, "MTEPS", f,
            runs=N_HUBS, hubs=hs,
            components=int(torch.unique(labels[0, :v]).numel()))
    if "msbfs" in only:
        warm, rts = roots(deg)
        warm_pulls = []
        levels, t, f = timed(
            "msbfs", lambda: warm_pulls.append(msbfs_pulls(
                bfs.vgl_msbfs(graph, warm).values)),
            lambda: bfs.vgl_msbfs(graph, rts).values)
        per_root = traversed_per_root(levels, graph.outgoing.degrees)
        row(f"bfs_msbfs_{NAME}_gteps", sum(per_root) / t / 1e9, "GTEPS", f,
            roots=N_ROOTS, edges_traversed=sum(per_root),
            levels=int(levels.max()),
            pulls={"warmup": warm_pulls[0], "timed": msbfs_pulls(levels)},
            reached=[int(n) for n in (levels > 0).sum(1)],
            protocol="bit-parallel multi-source (MS-BFS), two 32-root "
            "words, one or-pull per level")
    return rows


def _original(values: torch.Tensor, s2o: torch.Tensor, v: int) -> np.ndarray:
    """[k, v_pad] rows in a sorted ordering -> [k, v] in ORIGINAL ids, on
    the host (no launch)."""
    vals = values[:, :v].cpu().numpy()
    out = np.empty_like(vals)
    out[:, s2o[:v].cpu().numpy()] = vals
    return out


def check(ec, graph, results: dict, want: dict) -> dict:
    """The rows' last outputs (results) against the host oracle's (want:
    exp_lj_oracle.oracle's dict); -> the check's row fields, "ok" among
    them."""
    from ..utils.verify import equal_components, verify_results
    v, out = graph.v, {}
    if "cc" in results:
        # every run's labels (ORIGINAL ordering) against scipy's, up to
        # relabelling
        runs = results["cc"][:, :v].cpu().numpy()
        out["components"] = [[len(np.unique(r)) for r in runs],
                             want["components"]]
        out["cc_errors"] = [equal_components(r, want["labels"])
                            for r in runs]
        out["cc_ok"] = not any(out["cc_errors"])
    if "msbfs" in results:
        lv = results["msbfs"]
        reached = _original(lv, graph.outgoing.sorted_to_orig, v) > 0
        per_root = traversed_per_root(lv, graph.outgoing.degrees)
        out["reached_mismatches"] = int((reached != want["reached"]).sum())
        out["edges_traversed"] = [sum(per_root),
                                  int(want["traversed"].sum())]
        out["msbfs_ok"] = out["reached_mismatches"] == 0 and \
            per_root == want["traversed"].tolist()
    if "sssp" in results:
        dist = _original(results["sssp"], graph.incoming.sorted_to_orig, v)
        errors = [verify_results(d, w) for d, w in zip(dist, want["dist"])]
        out["sssp_errors"] = errors
        out["sssp_ok"] = not any(errors)
    out["ok"] = all(val for k, val in out.items() if k.endswith("_ok"))
    return out


def run(ec, device="cuda", only=ROWS, check_rows: bool = False,
        results=None) -> list:
    """Import ec onto `device`, emit the rows of `only` and, with
    check_rows, the oracle's row; -> every row."""
    ec, graph, ea, load_row = load(ec, device)
    results = {} if results is None else results
    rows = [load_row] + measure(ec, graph, ea, device, only, results)
    if check_rows:
        from . import exp_lj_oracle
        deg = out_degrees(ec)
        want = exp_lj_oracle.oracle(
            ec, sources(deg)[1] if "sssp" in only else [],
            roots(deg)[1] if "msbfs" in only else [])
        rows.append(emit(dict(metric="check", **check(ec, graph, results,
                                                      want),
                              oracle_s=want["seconds"],
                              **_base(ec, torch.device(device)))))
    return rows


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="bench_lj")
    p.add_argument("rows", nargs="*", choices=ROWS,
                   help="the rows to run (all by default)")
    p.add_argument("-dev", default="cuda",
                   help="where the algorithms run (cuda; cpu for the tests)")
    p.add_argument("-check", action="store_true",
                   help="hold the rows to the host oracle (exp_lj_oracle)")
    return p


def main(argv=None) -> int:
    from ..io import corpus
    args = parser().parse_args(argv)
    ec = corpus.load(NAME, fetch=False)
    if ec is None:
        emit({"note": f"no {NAME} under {corpus.graph_dir()}; run python -m "
              "vectorgraphlibrary_tpu_torch.apps.make_lj_replica first"})
        return 1
    rows = run(ec, args.dev, tuple(args.rows) or ROWS, args.check)
    log("done")
    return 0 if not args.check or rows[-1]["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
