"""PyTorch port, the spans of runtime/profiling.annotate: without a
profiler a span enters no record function; under a CPU torch.profiler the
host loops of PageRank, CC hybrid, DO-BFS and the SSSP paths give their
spans, nested block in block, with one vgl.host_read per host read; the
import keeps its phases' spans with or without a profiler."""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile

from vectorgraphlibrary_tpu_torch.graph.device import import_graph
from vectorgraphlibrary_tpu_torch.graph.edges import \
    build_edge_array_from_host
from vectorgraphlibrary_tpu_torch.io import generation
from vectorgraphlibrary_tpu_torch.models import bfs, cc, common, pr, sssp
from vectorgraphlibrary_tpu_torch.runtime import profiling

READ = "vgl.host_read"


@pytest.fixture(scope="module")
def graph():
    ec = generation.rmat(scale=9, avg_degree=8, seed=3)
    host = []
    g = import_graph(ec, device="cpu", _host_out=host, build_route=False)
    w = np.random.default_rng(0).uniform(1, 100, ec.edges_count)
    ea = build_edge_array_from_host(w.astype(np.float32), g, host[0],
                                    host[1])
    src = common.select_random_source(ec, seed=2)
    return g, ea, src


class Span:
    def __init__(self, name, start, end):
        self.name, self.start, self.end = name, start, end
        self.children = []

    def names(self):
        return [c.name for c in self.children]


def spans_of(fn):
    """(fn's result, the vgl.* spans it gave under a CPU profiler as trees,
    every name the profiler recorded)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = list(prof.profiler.kineto_results.events())
    rows = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in events if e.name().startswith("vgl.")),
                  key=lambda r: (r[1], -r[2]))
    roots, stack = [], []
    for name, start, end in rows:
        node = Span(name, start, end)
        while stack and stack[-1].end < end:
            stack.pop()
        (stack[-1].children if stack else roots).append(node)
        stack.append(node)
    return out, roots, {e.name() for e in events}


def walk(node):
    yield node
    for c in node.children:
        yield from walk(c)


def test_without_a_profiler_no_span_enters_a_record_function(graph,
                                                             monkeypatch):
    g, _, src = graph
    calls = []

    def counted(real):
        def make(*args, **kwargs):
            calls.append(args[0])
            return real(*args, **kwargs)
        return make

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        counted(torch._C._profiler._RecordFunctionFast))
    monkeypatch.setattr(torch.profiler, "record_function",
                        counted(torch.profiler.record_function))
    assert not torch.autograd._profiler_enabled()
    assert profiling.annotate("vgl.a") is profiling.annotate("vgl.b")
    pr.vgl_page_rank(g, max_iterations=2, use_convergence=False)
    bfs.vgl_bfs_device(g, src)
    with profiling.step_annotate("pr", 0):
        cc.vgl_cc_hybrid(g)
    assert calls == []
    # the same spans reach the profiler once one records
    _, roots, _ = spans_of(lambda: bfs.vgl_bfs_device(g, src))
    assert [r.name for r in roots] == ["vgl.bfs"]
    assert "vgl.bfs" in calls and READ in calls


def test_pagerank_spans(graph):
    g, _, _ = graph
    _, roots, _ = spans_of(lambda: pr.vgl_page_rank(
        g, max_iterations=3, use_convergence=False))
    (root,) = roots
    assert root.name == "vgl.pr"
    assert root.names() == ["vgl.pr.constants"] + ["vgl.pr.iteration"] * 3
    assert "vgl.route" in root.children[0].names()
    for it in root.children[1:]:
        assert it.names() == ["vgl.advance.pull"]
    # fixed iterations read nothing; the convergence test reads once each
    assert not any(n.name == READ for n in walk(root))
    (_, iters), roots, _ = spans_of(lambda: pr.vgl_page_rank(g))
    reads = [n for n in walk(roots[0]) if n.name == READ]
    assert len(reads) == iters > 3


def test_cc_hybrid_spans(graph):
    g, _, _ = graph
    _, roots, _ = spans_of(lambda: cc.vgl_cc_hybrid(g))
    (root,) = roots
    assert root.name == "vgl.cc"
    assert root.names()[0] == "vgl.cc.hub"
    assert root.children[0].names()[-1] == READ       # int(argmax)
    kinds = root.names()[1:]
    floods, hooks = kinds.count("vgl.cc.flood"), kinds.count("vgl.cc.hook")
    assert floods >= 1 and hooks >= 1
    # a flag before each flood level and hook iteration, and the last
    # flag of each loop
    assert kinds.count(READ) == floods + 1 + hooks + 1
    assert set(kinds) == {"vgl.cc.flood", "vgl.cc.hook", READ}
    for n in root.children[1:]:
        if n.name != READ:
            assert set(n.names()) == {"vgl.route", "vgl.advance.pull"}


def test_bfs_level_spans_follow_its_branches(graph):
    g, _, src = graph
    trace = []
    _, roots, _ = spans_of(lambda: bfs.vgl_bfs_device(
        g, src, id_cap=64, edge_cap=256, trace=trace))
    (root,) = roots
    assert root.name == "vgl.bfs"
    levels = [c for c in root.children if c.name != READ]
    assert {t[0] for t in trace} == {"td", "bu"}
    assert [c.name for c in levels] == [f"vgl.bfs.level.{t[0]}"
                                        for t in trace]
    reads = [n for n in walk(root) if n.name == READ]
    assert len(reads) == len(trace) + 1
    assert root.children[0].name == READ               # the source's degree
    for c in levels:
        assert c.names()[-1] == READ
        want = {"vgl.frontier.compact", "vgl.advance.push"} \
            if c.name.endswith("td") else {"vgl.advance.pull"}
        assert want <= set(c.names())


def test_sssp_sweep_spans(graph):
    g, ea, src = graph
    trace = []
    (_, iters), roots, _ = spans_of(
        lambda: sssp.vgl_dijkstra_partial_device(g, ea, src, id_cap=64,
                                                 edge_cap=512, trace=trace))
    (root,) = roots
    assert root.name == "vgl.sssp"
    # the out-degrees' route, the source's start, then the sweeps
    assert root.names()[:2] == ["vgl.route", READ]
    sweeps = root.children[2:]
    assert {t[0] for t in trace} == {"push", "dense"}
    assert [c.name for c in sweeps] == [
        "vgl.sssp.sweep." + t[0] for t in trace]
    assert len([n for n in walk(root) if n.name == READ]) == iters + 1
    (_, iters), roots, _ = spans_of(
        lambda: sssp.vgl_dijkstra_all_active(g, ea, src))
    (root,) = roots
    assert root.name == "vgl.sssp"
    assert root.names().count("vgl.sssp.sweep.all") == iters
    assert root.names().count(READ) == iters + 1


def test_no_span_name_takes_a_prefix_the_trace_reader_sorts_by(graph):
    g, ea, src = graph
    names = set()
    for fn in (lambda: pr.vgl_page_rank(g, max_iterations=2),
               lambda: cc.vgl_cc_hybrid(g),
               lambda: bfs.vgl_bfs_device(g, src),
               lambda: sssp.vgl_dijkstra_multi(g, ea, [src],
                                               all_active=False)):
        _, roots, _ = spans_of(fn)
        names |= {n.name for r in roots for n in walk(r)}
    assert len(names) >= 15
    assert not any(n.startswith(("job:", "cuda")) for n in names)
    assert all(n.startswith("vgl.") for n in names)


def test_the_import_keeps_its_phases():
    ec = generation.rmat(scale=9, avg_degree=8, seed=4)
    t0 = time.perf_counter()
    host = []
    g = import_graph(ec, device="cpu", _host_out=host)
    build_edge_array_from_host(np.ones(ec.edges_count, np.float32), g,
                               host[0], host[1])
    wall = time.perf_counter() - t0
    kept = [k for k in profiling.kept_spans() if k[1] >= t0]
    names = [k[0] for k in kept]
    assert sorted(names) == sorted(
        ["vgl.import", "vgl.import.csr", "vgl.import.csr",
         "vgl.import.csr.device", "vgl.import.csr.device",
         "vgl.import.to_device", "vgl.import.advance_route",
         "vgl.import.vertex_routes", "vgl.import.edge_values"])
    (_, lo, hi), = [k for k in kept if k[0] == "vgl.import"]
    phases = [k for k in kept if k[0].startswith("vgl.import.")
              and k[0] != "vgl.import.edge_values"]
    assert all(lo <= s <= e <= hi for _, s, e in phases)
    # each direction's device build lies inside its own vgl.import.csr
    csr = [k for k in kept if k[0] == "vgl.import.csr"]
    dev = [k for k in kept if k[0] == "vgl.import.csr.device"]
    assert all(c[1] <= d[1] <= d[2] <= c[2] for c, d in zip(csr, dev))
    assert sum(e - s for n, s, e in kept
               if n not in ("vgl.import", "vgl.import.csr.device")) <= wall
    # under a profiler the kept spans are spans of the trace as well
    _, roots, _ = spans_of(lambda: import_graph(ec, device="cpu",
                                                build_route=False))
    (root,) = roots
    assert root.name == "vgl.import"
    assert root.names() == ["vgl.import.to_device", "vgl.import.csr",
                            "vgl.import.csr",
                            "vgl.import.vertex_routes"]
    assert [c.names() for c in root.children[1:3]] == \
        [["vgl.import.csr.device"]] * 2
    assert profiling.kept_spans()[-1][0] == "vgl.import"
