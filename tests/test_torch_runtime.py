"""PyTorch port, the measurement runtime on the CPU: the timers, the
per-primitive stats and their printed text (the JAX package's, character
for character, for the same stats), the profiling hooks, init_library, the
per-primitive profiling pass (the JAX package's rows, calls and
edges-visited on the same graph) and the app skeleton that runs it."""
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorgraphlibrary_tpu.config import VGLConfig as JConfig
from vectorgraphlibrary_tpu.runtime import perf_stats as jstats
from vectorgraphlibrary_tpu.runtime import prim_profile as jprim
from vectorgraphlibrary_tpu.runtime import runtime as jruntime
from vectorgraphlibrary_tpu.runtime import timer as jtimer

from vectorgraphlibrary_tpu_torch.apps import pr as pr_app
from vectorgraphlibrary_tpu_torch.apps.app_common import run_app
from vectorgraphlibrary_tpu_torch.config import VGLConfig
from vectorgraphlibrary_tpu_torch.runtime import perf_stats, prim_profile
from vectorgraphlibrary_tpu_torch.runtime import profiling, runtime, timer

CPU = torch.device("cpu")
ROWS = ("reorder (vertex route)", "advance (pull add)",
        "advance (push sparse)", "generate_new_frontier")


def test_timer_on_host_clock(capsys):
    t = timer.Timer().start()
    time.sleep(0.002)
    s = t.stop()
    assert s >= 0.002 and t.seconds == s and t.ms == s * 1e3
    for tm in (timer.Timer(), jtimer.Timer()):
        tm._elapsed = 0.0123456
        tm.print_bandwidth_stats("route", 3.5e9)
    port, ref = capsys.readouterr().out.splitlines()
    assert port == ref == "route time: 12.346 ms, bandwidth: 283.50 GB/s"


def test_device_timer_and_block_on_cpu():
    x = torch.arange(10)
    tree = {"a": [x, (x + 1,)], "b": None}
    assert timer.block(tree) is tree and timer.block(x) is x
    t = timer.DeviceTimer(CPU).start()
    time.sleep(0.002)
    assert t.stop(tree) >= 0.002
    assert timer.DeviceTimer().device == torch.device("cuda")
    assert timer.DeviceTimer("cpu").device == CPU


# (primitive, wall_s, bytes, edges) update calls, and the fixed inner wall
STATS_CASES = {
    "rows": ([("advance (pull add)", 0.0021, 3.67e7, 8388608),
              ("reorder (vertex route)", 1.2e-5, 3145728, 262144),
              ("advance (pull add)", 0.0019, 3.67e7, 8388608),
              ("generate_new_frontier", 4e-4, 425984, 262144)], 0.25),
    "inner from the rows": ([("advance (push sparse)", 3e-4, 2.1e6,
                              131072)], 0.0),
    "no rows": ([], 0.5),
}


@pytest.mark.parametrize("case", list(STATS_CASES))
def test_print_timers_stats_equals_reference(capsys, case):
    updates, inner = STATS_CASES[case]
    texts = []
    for mod in (perf_stats, jstats):
        st = mod.PerformanceStats(hbm_roofline_gbps=819.0)
        for u in updates:
            st.update(*u)
        st.inner_wall_s = inner
        st.print_timers_stats()
        texts.append(capsys.readouterr().out)
    assert texts[0] == texts[1]
    assert texts[0].splitlines()[0].split() == [
        "primitive", "ms", "%", "GB/s", "%roof", "MTEPS", "calls"]


@pytest.mark.parametrize("samples", [[], [(0.5, 8192)],
                                     [(0.1, 8388608), (0.3, 8388608),
                                      (0.2, 8388607)]])
def test_report_performance_equals_reference(capsys, samples):
    outs, avgs = [], []
    for mod in (perf_stats, jstats):
        st = mod.PerformanceStats(hbm_roofline_gbps=819.0)
        for wall, edges in samples:
            st.save_algorithm_performance_stats("pr", wall, edges)
        avgs.append(st.report_performance("pr"))
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and avgs[0] == avgs[1]
    assert "AVG_PERF: " in outs[0]


def test_timed_accrues_and_defaults():
    st = perf_stats.PerformanceStats()
    assert st.hbm_roofline_gbps == perf_stats.H100_HBM_GBPS == 3350.0
    for _ in range(2):
        with st.timed("advance", bytes_requested=100.0, edges_visited=7.0,
                      sync={"x": torch.ones(3)}):
            time.sleep(0.001)
    s = st.stats["advance"]
    assert (s.calls, s.bytes_requested, s.edges_visited) == (2, 200.0, 14.0)
    assert s.wall_s >= 0.002
    st.start_measuring_stats()
    assert not st.stats
    st.stop_measuring_stats()
    assert st.inner_wall_s >= 0.0
    assert isinstance(perf_stats.performance_stats,
                      perf_stats.PerformanceStats)


@pytest.mark.parametrize("log_dir", ["trace", "", None])
def test_trace_writes_chrome_trace(tmp_path, log_dir):
    d = None if log_dir is None else (str(tmp_path / log_dir) if log_dir
                                      else "")
    with profiling.trace(d):
        with profiling.annotate("advance:pr"):
            for step in range(2):
                with profiling.step_annotate("pr", step):
                    torch.ones(64).cumsum(0)
    files = sorted(os.listdir(tmp_path))
    if not log_dir:
        assert files == []
        return
    (name,) = os.listdir(d)
    assert name.startswith("trace_") and name.endswith(".json")
    with open(os.path.join(d, name)) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"advance:pr", "pr#0", "pr#1"} <= names


def test_trace_dir_from_env(monkeypatch):
    monkeypatch.delenv(profiling.TRACE_DIR_ENV, raising=False)
    assert profiling.trace_dir_from_env() is None
    monkeypatch.setenv(profiling.TRACE_DIR_ENV, "/x/y")
    assert profiling.trace_dir_from_env() == "/x/y"


def test_device_memory_profile_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present (tests/test_torch_cuda.py)")
    path = tmp_path / "mem.pickle"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.device_memory_profile(str(path))
    assert not path.exists()


def test_init_library(capsys):
    assert runtime.init_library(VGLConfig(device="cpu")) == CPU
    assert capsys.readouterr().out == "VGL (PyTorch) init: device cpu\n"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device is available"):
            runtime.init_library(VGLConfig())
    runtime.start_measuring_stats()
    runtime.stop_measuring_stats()
    assert capsys.readouterr().out.splitlines()[-1].startswith("inner wall")
    runtime.finalize_library()


@pytest.fixture(scope="module")
def graphs():
    """The same weighted scale-10 graph in both packages."""
    cfg = dict(scale=10, avg_degree=8, seed=42)
    _, jg, jw = jruntime.prepare_graph(JConfig(**cfg), need_weights=True)
    _, tg, tw = runtime.prepare_graph(VGLConfig(**cfg), need_weights=True,
                                      device="cpu")
    return jg, jw, tg, tw


@pytest.mark.parametrize("weighted", [True, False])
def test_prim_profile_rows_equal_reference(graphs, weighted):
    jg, jw, tg, tw = graphs
    js, ts = jstats.PerformanceStats(), perf_stats.PerformanceStats()
    jprim.profile_graph_primitives(jg, jw if weighted else None, stats=js)
    prim_profile.profile_graph_primitives(tg, tw if weighted else None,
                                          stats=ts, reps=2)
    min_row = "advance (pull min+w)" if weighted else "advance (pull min)"
    assert set(ts.stats) == set(js.stats) == {*ROWS, min_row}
    for name in js.stats:
        j, t = js.stats[name], ts.stats[name]
        assert (t.calls, t.edges_visited) == (j.calls, j.edges_visited), name
        assert t.wall_s > 0, name
    v, e = tg.v_pad, tg.e
    pull = 4 * (v + 1) + 4 * e + 8 * v
    m = min(int(tg.outgoing.degrees[:1024].sum()), min(1 << 17, e))
    want = {"reorder (vertex route)": 12 * v, "advance (pull add)": pull,
            min_row: pull + 4 * e * weighted,
            "advance (push sparse)": 17 * 1024 + 4 * m + 8 * v,
            "generate_new_frontier": v + 5 * (1 << 15)}
    assert {k: s.bytes_requested for k, s in ts.stats.items()} == want


@pytest.mark.parametrize("baseline,want", [(0.0, 1.0), (1.0, 0.05)])
def test_timeit_subtracts_the_baseline_with_a_floor(monkeypatch, baseline,
                                                    want):
    """The best time less the dispatch baseline, floored at 5 % of the best
    time; one untimed call first."""
    monkeypatch.setattr(prim_profile, "_dispatch_baseline",
                        lambda device: baseline)
    calls = []

    def fn():
        calls.append(1)
        time.sleep(0.01)
    got = prim_profile._timeit(fn, CPU, 2)
    assert len(calls) == 3
    assert want * 0.01 <= got < want * 0.02


def _pr_app(argv, capsys):
    rc = run_app("pr", pr_app.run_round, pr_app.check_round,
                 needs_source=False,
                 argv=["-s", "10", "-e", "8", "-it", "2", "-check", "-dev",
                       "cpu", *argv])
    return rc, capsys.readouterr().out


def test_run_app_prints_the_prim_table(capsys, tmp_path, monkeypatch):
    monkeypatch.setenv(profiling.TRACE_DIR_ENV, str(tmp_path))
    rc, out = _pr_app([], capsys)
    assert rc == 0 and out.count("error count: 0") == 2
    lines = out.splitlines()
    head = lines.index(next(ln for ln in lines if ln.startswith("primitive")))
    table = [ln[:24].rstrip() for ln in lines[head + 1:head + 6]]
    assert sorted(table) == sorted([*ROWS, "advance (pull min)"])
    assert lines[head + 6].startswith("inner wall")
    assert lines.index(next(ln for ln in lines
                            if ln.startswith("AVG_PERF:"))) > head
    (trace,) = os.listdir(tmp_path)
    with open(tmp_path / trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"pr#0", "pr#1"} <= names


def test_run_app_without_prim_stats(capsys, monkeypatch):
    monkeypatch.delenv(profiling.TRACE_DIR_ENV, raising=False)
    rc, out = _pr_app(["-no-prim-stats"], capsys)
    assert rc == 0 and out.count("error count: 0") == 2
    assert "AVG_PERF:" in out
    assert not any(row in out for row in ROWS)
    lines = out.splitlines()
    head = lines.index(next(ln for ln in lines if ln.startswith("primitive")))
    assert lines[head + 1].startswith("inner wall")
    assert np.isfinite(perf_stats.performance_stats.inner_wall_s)
