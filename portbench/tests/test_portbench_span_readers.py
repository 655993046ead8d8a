"""The readers of the port's own spans (spans.py and its metrics) on
hand-made traces: gaps put down to a host read by launch times on the
host's clock, also where the device's clock is shifted; host reads per
job; the import's kept phases; nothing read without the spans."""
import pytest

from portbench import spans
from portbench.cell import load_cell
from portbench.harness import Job, Run, run_cell
from portbench.trace import Trace, breakdown, idle_gaps
from conftest import REPO

QUIET = {"log": lambda msg: None}
SHIFT = 5000.0          # the device's clock 5 ms ahead of the host's


def _run(cell, trace, jobs=()):
    return Run(cell=load_cell(REPO, cell), device_kind="NVIDIA H100 80GB HBM3",
               v=100, e=1000, v_pad=128, setup={"setup_s": 1.0},
               jobs=list(jobs), window_s=1.0, trace=trace)


def _reader(name, cell="graph500-s21.sweep"):
    return load_cell(REPO, cell).metric_reader(name)


def _shifted(name, start, end, launch):
    return (name, start + SHIFT, end + SHIFT, launch)


# One CC job on the host's clock (us). A hook iteration launches A, reads
# its flag (a synchronize that returns once A is done), then launches B;
# C is launched late by the host alone, with no read between.
SPANS = [("cc", 0.0, 40000.0)]
HOST = [("vgl.cc", 100.0, 39000.0),
        ("vgl.cc.hook", 1000.0, 9000.0),
        ("aten::min", 1500.0, 1600.0),
        ("vgl.host_read", 10000.0, 12000.0),
        ("cudaStreamSynchronize", 10100.0, 11990.0),
        ("vgl.cc.hook", 12500.0, 30000.0),
        ("aten::sum", 17000.0, 18200.0),
        ("cudaLaunchKernel", 13000.0, 13005.0)]
# device operations, each on the device's clock, with its host launch
DEVICE = [_shifted("A", 2000.0, 11950.0, 1500.0),
          _shifted("B", 13010.0, 14000.0, 13000.0),
          _shifted("C", 15000.0, 16000.0, 14500.0),
          _shifted("D", 16000.0, 34000.0, 15900.0)]


def test_gaps_are_put_down_to_a_host_read_by_launch_times():
    t = Trace(spans=SPANS, device=DEVICE, host=HOST)
    gs, ge, before, after = spans.gap_launches(t)
    # the inner gaps: after A (opened by the read) and after B; the gaps at
    # the window's edges have no operation on one side
    got = sorted(zip(gs - SHIFT, ge - SHIFT, before, after))
    assert got == [(11950.0, 13010.0, 1500.0, 13000.0),
                   (14000.0, 15000.0, 13000.0, 14500.0)]
    assert spans.host_read_idle_us(t) == pytest.approx(1060.0)
    assert spans.host_read_idle_pct(t) == pytest.approx(
        100 * 1060.0 / 40000.0)
    # named by its middle on the device's clock, the read's gap reads as a
    # sum the host ran 5 ms later; named by the launch that closed it, it
    # falls in the second hook iteration
    (name, _), = [g for g in breakdown(t)["idle_gaps"]
                  if g[1] == pytest.approx(1060e-6)]
    assert name == "cc: aten::sum"
    by_span = spans.idle_by_span(t)
    assert by_span["vgl.cc.hook"] == [pytest.approx(1060e-6 + 1000e-6), 2]
    assert _reader("host_read_idle_pct.sweep").read(
        _run("graph500-s21.sweep", t)) == pytest.approx(100 * 1060 / 40000)


def test_a_read_outside_the_launches_around_a_gap_does_not_count():
    # B launched before the read ended: the read did not hold it back
    dev = [_shifted("A", 2000.0, 11950.0, 1500.0),
           _shifted("B", 13010.0, 14000.0, 11000.0)]
    t = Trace(spans=SPANS, device=dev, host=HOST)
    assert spans.host_read_idle_us(t) == 0.0
    assert spans.host_read_idle_pct(t) == 0.0


def test_gap_lengths_are_those_of_the_trace():
    t = Trace(spans=SPANS, device=DEVICE, host=HOST)
    gs, ge, _, _ = spans.gap_launches(t)
    inner = [g for g in idle_gaps(t) if SPANS[0][1] < g[0]
             and g[1] < SPANS[0][2]]
    assert sorted(zip(gs, ge)) == sorted(inner)


def test_host_reads_per_job_count_reads_inside_each_kinds_jobs():
    jobs = [("bfs", 0.0, 100.0), ("sssp", 100.0, 200.0),
            ("bfs", 200.0, 300.0)]
    host = [("vgl.bfs", 1.0, 99.0), ("vgl.host_read", 2.0, 3.0),
            ("vgl.bfs.level.td", 4.0, 20.0), ("vgl.host_read", 18.0, 19.0),
            ("vgl.host_read", 120.0, 121.0), ("vgl.host_read", 201.0, 202.0),
            ("vgl.host_read", 350.0, 351.0), ("aten::item", 18.0, 19.0)]
    t = Trace(spans=jobs, device=[("k", 5.0, 6.0, 5.0)], host=host)
    run = _run("chung-lu-lj-size.traverse", t)
    cell = "chung-lu-lj-size.traverse"
    assert _reader("host_reads_per_job.bfs", cell).read(run) == 1.5
    assert _reader("host_reads_per_job.sssp", cell).read(run) == 1.0
    assert spans.host_reads_per_job(t, "cc") is None


def test_the_innermost_span_holds_each_time():
    host = [("vgl.bfs", 0.0, 100.0), ("vgl.bfs.level.td", 10.0, 40.0),
            ("vgl.frontier.compact", 12.0, 20.0),
            ("vgl.bfs.level.bu", 40.0, 90.0), ("vgl.route", 50.0, 60.0)]
    names, starts, ends = spans.vgl_spans(Trace(spans=[], device=[],
                                                host=host))
    got = spans.innermost(starts, ends, [5.0, 15.0, 30.0, 55.0, 95.0, 120.0])
    assert [names[i] if i >= 0 else None for i in got] == [
        "vgl.bfs", "vgl.frontier.compact", "vgl.bfs.level.td", "vgl.route",
        "vgl.bfs", None]


def test_mallocs_in_the_window_are_named_by_their_span():
    host = HOST + [("cudaMalloc", 20000.0, 22000.0),
                   ("cudaMalloc", 50000.0, 50100.0)]
    t = Trace(spans=SPANS, device=DEVICE, host=host)
    assert spans.mallocs(t) == [("vgl.cc.hook", 2.0)]


@pytest.fixture
def kept(monkeypatch):
    from vectorgraphlibrary_tpu_torch.runtime import profiling
    rows = []
    monkeypatch.setattr(profiling, "kept_spans", lambda: list(rows))
    return rows


def test_import_readers_take_the_last_imports_phases(kept):
    kept += [("vgl.import.csr", 1.0, 3.0), ("vgl.import", 0.0, 10.0),
             ("vgl.import.csr", 11.0, 12.0), ("vgl.import.csr", 12.0, 14.5),
             ("vgl.import.to_device", 14.5, 15.0),
             ("vgl.import.vertex_routes", 15.0, 15.25),
             ("vgl.import", 10.5, 16.0), ("vgl.import.edge_values", 16, 17)]
    run = _run("graph500-s21.sweep", None)
    assert _reader("import_csr_s").read(run) == 3.5
    assert _reader("import_routes_s").read(run) == 0.25


def test_nothing_is_read_without_the_spans(kept, monkeypatch):
    t = Trace(spans=SPANS, device=DEVICE,
              host=[h for h in HOST if not h[0].startswith("vgl.")])
    names = ["host_read_idle_pct.sweep", "host_read_idle_pct.traverse",
             "host_reads_per_job.cc", "host_reads_per_job.bfs",
             "host_reads_per_job.sssp", "import_csr_s", "import_routes_s"]
    for trace in (t, None):
        run = _run("graph500-s21.sweep", trace, [Job("cc", 1.0, 1)])
        assert [_reader(n).read(run) for n in names] == [None] * 7
    # a program without kept spans at all, as before them
    from vectorgraphlibrary_tpu_torch.runtime import profiling
    monkeypatch.delattr(profiling, "kept_spans")
    assert _reader("import_csr_s").read(_run("graph500-s21.sweep", t)) \
        is None


def test_a_traced_tiny_run_reads_the_ports_spans(tiny_root):
    """On the CPU the trace holds no device operation: the counts and the
    import's phases are read, the idle share is not."""
    r = run_cell(tiny_root, "tiny-cl.traverse", 7, 0.3, True, "cpu", **QUIET)
    m = r["metrics"]
    assert r["correct"]
    assert m["host_reads_per_job.bfs"]["value"] >= 3
    assert m["host_reads_per_job.sssp"]["value"] >= 3
    assert m["import_csr_s"]["value"] > 0 and m["import_routes_s"]["value"] > 0
    assert "host_read_idle_pct.traverse" not in m


def test_device_time_goes_to_the_span_of_its_launch():
    t = Trace(spans=SPANS, device=DEVICE + [
        ("elementwise_kernel_with_index", 20000.0, 20500.0, 12600.0)],
        host=HOST)
    by = spans.device_by_span(t)
    assert by["vgl.cc.hook"] == pytest.approx((9950 + 990 + 1000 + 18000
                                               + 500) / 1e6)
    assert spans.device_by_span(t, spans.ARANGE) == {
        "vgl.cc.hook": pytest.approx(500e-6)}
