"""The rate, idle-share, roofline and breakdown arithmetic on hand-made
inputs."""
import random

import pytest

from portbench import roofline
from portbench.cell import load_cell
from portbench.harness import Job, Run, _Reservoir, end_to_end
from portbench.trace import (Trace, breakdown, busy_us, device_in_spans,
                             idle_gaps, idle_pct)
from conftest import REPO


def _run(cell="graph500-s21.sweep", jobs=(), trace=None, v=100, e=1000,
         v_pad=128, setup_s=50.0):
    return Run(cell=load_cell(REPO, cell), device_kind="NVIDIA H100 80GB HBM3",
               v=v, e=e, v_pad=v_pad, setup={"setup_s": setup_s,
                                             "import_s": 40.0},
               jobs=list(jobs), window_s=sum(j.seconds for j in jobs),
               trace=trace)


def test_rates_are_each_kinds_work_over_its_jobs_time():
    jobs = [Job("pagerank", 0.5, 2000), Job("cc", 0.25, 1000),
            Job("pagerank", 1.5, 2000), Job("cc", 0.75, 1000)]
    got = end_to_end(_run(jobs=jobs))
    assert got["pagerank_mteps"] == {"value": 4000 / 2.0 / 1e6,
                                     "unit": "MTEPS"}
    assert got["cc_mteps"]["value"] == pytest.approx(2000 / 1.0 / 1e6)
    assert got["setup_s"] == {"value": 50.0, "unit": "s"}


def test_traverse_rates_use_their_units():
    jobs = [Job("bfs", 0.1, 10**9), Job("sssp", 0.4, 10**9)]
    got = end_to_end(_run("chung-lu-lj-size.traverse", jobs=jobs))
    assert got["bfs_gteps"]["value"] == pytest.approx(10.0)
    assert got["sssp_mteps"]["value"] == pytest.approx(2500.0)
    assert set(got) == {"bfs_gteps", "sssp_mteps", "setup_s"}


SPANS = [("pagerank", 0.0, 100.0), ("cc", 100.0, 200.0),
         ("pagerank", 200.0, 300.0)]
DEVICE = [("void pull_reduce_kernel<float>", 10.0, 40.0),
          ("void pull_reduce_fixup_kernel<float>", 40.0, 45.0),
          ("elementwise", 30.0, 60.0),                 # overlaps the pull
          ("void pull_reduce_kernel<int>", 120.0, 145.0),
          ("void pull_reduce_kernel<float>", 210.0, 250.0),
          ("Memcpy DtoH", 290.0, 300.0)]
HOST = [("aten::item", 60.0, 95.0), ("cudaStreamSynchronize", 61.0, 90.0),
        ("aten::sort", 150.0, 199.0)]


def test_busy_and_idle_take_the_union_of_device_time():
    t = Trace(spans=SPANS, device=DEVICE, host=HOST)
    # busy: [10, 60] + [120, 145] + [210, 250] + [290, 300]
    assert busy_us(t) == pytest.approx(50 + 25 + 40 + 10)
    assert idle_pct(t) == pytest.approx(100 * (1 - 125 / 300))
    assert idle_gaps(t)[0] == (145.0, 210.0)
    assert sorted(idle_gaps(t)) == [(0.0, 10.0), (60.0, 120.0),
                                    (145.0, 210.0), (250.0, 290.0)]


def test_device_time_is_taken_by_span_kind_and_kernel_name():
    t = Trace(spans=SPANS, device=DEVICE, host=HOST)
    assert device_in_spans(t, "pagerank", r"pull_reduce_(fixup_)?kernel") \
        == (30.0 + 5.0 + 40.0, 3)
    assert device_in_spans(t, "cc", r"pull_reduce_kernel") == (25.0, 1)
    assert device_in_spans(t, "bfs", "") == (0.0, 0)


def test_breakdown_names_gaps_by_span_and_host_operation():
    t = Trace(spans=SPANS, device=DEVICE, host=HOST)
    b = breakdown(t, top=2)
    assert b["device_ops"][0] == ["void pull_reduce_kernel<float>",
                                 pytest.approx(70e-6)]
    assert len(b["device_ops"]) == 2
    # the longest gap [145, 210] spans two jobs: its middle, 177.5, is in
    # the cc span while the host sorts; the next, [60, 120], at 90 waits
    # on a synchronize
    assert b["idle_gaps"] == [["cc: aten::sort", pytest.approx(65e-6)],
                              ["pagerank: cudaStreamSynchronize",
                               pytest.approx(60e-6)]]


def test_pull_bytes_count_real_rows_never_the_padding():
    assert roofline.pull_bytes(100, 1000) == 4 * 101 + 4 * 1000 + 4 * 100 \
        + 4 * 100
    assert roofline.share_pct(3.35e9, 2e-3, "NVIDIA H100 80GB HBM3") \
        == pytest.approx(50.0)


def _reader(name):
    return load_cell(REPO, "graph500-s21.sweep").metric_reader(name)


def test_pagerank_roofline_uses_real_vertices_and_counted_pulls():
    t = Trace(spans=SPANS, device=DEVICE, host=HOST)
    jobs = [Job("pagerank", 1.0, 0, {"pull_reduce": 1}),
            Job("cc", 1.0, 0, {"pull_reduce": 1}),
            Job("pagerank", 1.0, 0, {"pull_reduce": 1})]
    run = _run(jobs=jobs, trace=t, v=1000, e=10**6, v_pad=1 << 20)
    got = _reader("pull_reduce_roofline.pagerank").read(run)
    want = 100 * 2 * roofline.pull_bytes(1000, 10**6) / 3.35e12 / 75e-6
    assert got == pytest.approx(want)
    # the same graph padded to more rows moves the same bytes
    run.v_pad = 1 << 24
    assert _reader("pull_reduce_roofline.pagerank").read(run) \
        == pytest.approx(want)


def test_pagerank_roofline_reads_nothing_when_the_trace_lost_a_pull():
    t = Trace(spans=SPANS, device=DEVICE, host=HOST)
    jobs = [Job("pagerank", 1.0, 0, {"pull_reduce": 2}),
            Job("cc", 1.0, 0, {}), Job("pagerank", 1.0, 0,
                                       {"pull_reduce": 1})]
    assert _reader("pull_reduce_roofline.pagerank").read(
        _run(jobs=jobs, trace=t)) is None
    assert _reader("pull_reduce_roofline.pagerank").read(
        _run(jobs=jobs, trace=None)) is None


def test_frontier_push_per_bfs_job():
    spans = [("bfs", 0.0, 100.0), ("sssp", 100.0, 200.0),
             ("bfs", 200.0, 300.0)]
    dev = [("DeviceRadixSortOnesweepKernel", 10.0, 30.0),
           ("push_expand_kernel", 30.0, 35.0),
           ("DeviceRadixSortOnesweepKernel", 110.0, 190.0),
           ("void scatter_combine_f32_kernel", 220.0, 225.0),
           ("pull_reduce_kernel", 230.0, 290.0)]
    run = _run("chung-lu-lj-size.traverse",
               jobs=[Job("bfs", 1, 0), Job("sssp", 1, 0), Job("bfs", 1, 0)],
               trace=Trace(spans=spans, device=dev, host=[]))
    got = _reader("frontier_push.device_ms_per_bfs").read(run)
    assert got == pytest.approx((20 + 5 + 5) / 1e3 / 2)


def test_idle_readers_and_import_reader():
    t = Trace(spans=SPANS, device=DEVICE, host=HOST)
    run = _run(jobs=[Job("pagerank", 1, 0)], trace=t)
    assert _reader("device_idle_pct.sweep").read(run) == pytest.approx(
        100 * (1 - 125 / 300))
    assert _reader("device_idle_pct.traverse").read(run) == \
        _reader("device_idle_pct.sweep").read(run)
    assert _reader("import_s").read(run) == 40.0
    assert _reader("device_idle_pct.sweep").read(_run()) is None


def test_one_reader_serves_a_metric_of_every_mix():
    """A metric without a file of its own is read by the file of its name
    less the last dotted part."""
    cell = load_cell(REPO, "graph500-s21.sweep")
    idle = cell.metric_reader("device_idle_pct")
    assert cell.metric_reader("device_idle_pct.sweep") is idle
    assert cell.metric_reader("device_idle_pct.traverse") is idle
    assert cell.metric_reader("pull_reduce_roofline.pagerank") is not idle
    with pytest.raises(FileNotFoundError):
        cell.metric_reader("no_such_metric.sweep")


def test_reservoir_draws_from_its_seed():
    def draw(seed):
        r = _Reservoir(3, random.Random(seed))
        for i in range(1000):
            r.offer(i)
        return r.items
    assert draw(5) == draw(5) and draw(5) != draw(6)
    assert len(draw(5)) == 3 and max(draw(5)) > 3


def test_device_time_is_placed_by_its_launch_time():
    """A kernel whose device clock reads just past its span's start of the
    next job still counts for the span whose host call launched it."""
    spans = [("pagerank", 0.0, 100.0), ("cc", 100.0, 200.0)]
    dev = [("pull_reduce_kernel", 90.0, 101.0, 95.0),
           ("pull_reduce_kernel", 99.0, 110.0, 60.0),
           ("pull_reduce_kernel", 150.0, 160.0, 140.0)]
    t = Trace(spans=spans, device=dev, host=[])
    assert device_in_spans(t, "pagerank", "pull") == (22.0, 2)
    assert device_in_spans(t, "cc", "pull") == (10.0, 1)


def test_no_roofline_for_a_card_without_peaks():
    assert roofline.share_pct(1e9, 1e-3, "NVIDIA A100-SXM4-40GB") is None
