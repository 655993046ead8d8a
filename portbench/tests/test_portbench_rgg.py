"""The rgg configuration as new files: a tiny stand-in (2^12 points) of
rgg-n22 and its deep cell run correct on the CPU, traced and not; the
round counts read the port's spans inside the job spans; on the card the
full-size draw keeps the generator's rules."""
import json
from types import SimpleNamespace

import pytest
import torch

from portbench.cell import load_module
from portbench.harness import run_cell
from portbench.trace import Trace
from conftest import REPO, add_cell

QUIET = {"log": lambda msg: None}
RGG = load_module(REPO / "portbench" / "gen" / "rgg.py")


@pytest.fixture
def rgg_root(tiny_root):
    """tiny_root with tiny-rgg (rgg-n22 at 2^12 points) and its deep cell."""
    cfg = json.loads((REPO / "portbench" / "configs" / "rgg-n22.json")
                     .read_text())
    cfg["params"]["vertices"] = 1 << 12
    (tiny_root / "portbench" / "configs" / "tiny-rgg.json").write_text(
        json.dumps(cfg))
    path = tiny_root / "BENCHMARK.json"
    bench = json.loads(path.read_text())
    bench["configs"].append({"name": "tiny-rgg", "source": "test",
                             "file": "portbench/configs/tiny-rgg.json",
                             "reduced": [], "why": "test"})
    path.write_text(json.dumps(bench))
    add_cell(tiny_root, "tiny-rgg", "deep")
    return tiny_root


def test_the_deep_cell_runs_correct_on_the_cpu(rgg_root):
    r = run_cell(rgg_root, "tiny-rgg.deep", 2**33 + 7, 0.3, False, "cpu",
                 **QUIET)
    assert r["correct"] and r["failed"] == 0, r["checks"]
    # the traversals run and are judged, and only CC's rate is reported
    assert set(r["metrics"]) == {"setup_s", "cc_mteps"}
    assert set(r["checks"]) == {"bfs_mismatched", "sssp_rel_err",
                                "cc_mismatched"}
    assert r["jobs"]["bfs"] == r["jobs"]["sssp"] == r["jobs"]["cc"] >= 1


def test_the_traced_deep_cell_reads_its_cc_rounds(rgg_root):
    r = run_cell(rgg_root, "tiny-rgg.deep", 2**31 + 3, 0.3, True, "cpu",
                 **QUIET)
    assert r["correct"], r["checks"]
    # no device operation on the CPU: the idle share stays out
    assert set(r["metrics"]) == {"levels_per_job.cc"}
    # the flood closes at 2^12 points: its levels and a few hooks
    assert r["metrics"]["levels_per_job.cc"]["value"] >= 20


def test_the_rounds_reader_counts_spans_inside_the_cc_jobs():
    """Two cc jobs and a bfs job; spans outside every cc job, or of
    another name, do not count."""
    reader = load_module(REPO / "portbench" / "metrics"
                         / "levels_per_job.cc.py")
    trace = Trace(
        spans=[("cc", 0, 10), ("bfs", 20, 30), ("cc", 40, 50)],
        device=[],
        host=[(name, t, t + 0.5) for name, t in (
            ("vgl.cc.flood", 1), ("vgl.cc.hook", 2), ("vgl.cc.link", 3),
            ("vgl.cc.compress", 4), ("vgl.host_read", 5),
            ("vgl.cc.link", 41), ("vgl.cc.flood", 15),
            ("vgl.cc.flood", 21), ("vgl.bfs.level.td", 22))])
    assert reader.read(SimpleNamespace(trace=trace)) == 2.0
    # a program without the spans, a window without cc jobs, no trace
    bare = Trace(spans=trace.spans, device=[], host=[])
    assert reader.read(SimpleNamespace(trace=bare)) is None
    no_cc = Trace(spans=[("bfs", 20, 30)], device=[], host=trace.host)
    assert reader.read(SimpleNamespace(trace=no_cc)) is None
    assert reader.read(SimpleNamespace(trace=None)) is None


@pytest.mark.gpu
def test_the_full_draw_on_the_card(card):
    params = {"vertices": 1 << 22, "radius_factor": 0.55}
    src, dst, v = RGG.edges(params, 22, card)
    again = RGG.edges(params, 22, card)
    assert torch.equal(src, again[0]) and torch.equal(dst, again[1])
    e = src.numel() // 2
    assert torch.equal(src[e:], dst[:e]) and torch.equal(dst[e:], src[:e])
    assert not bool((src == dst).any())
    key = src.long() * v + dst.long()
    assert torch.unique(key).numel() == 2 * e
    deg = torch.bincount(src.long(), minlength=v)
    # the mean degree is near pi r^2 v, less a little at the border
    r = RGG.radius(params)
    assert abs(2 * e / v - 3.14159 * r * r * v) < 0.5
    print(f"rgg 2^22 on the card: {e:,} edges, {2 * e:,} arcs, "
          f"largest degree {int(deg.max())}, "
          f"isolated {int((deg == 0).sum())}")


@pytest.mark.gpu
def test_a_card_draw_is_the_brute_force_pairs(card):
    params = {"vertices": 1 << 14, "radius_factor": 0.55}
    src, dst, v = RGG.edges(params, 2**31 + 1, card)
    pts = RGG.points(params, 2**31 + 1, card)
    r2 = RGG.radius(params) ** 2
    got = torch.zeros(v, v, dtype=torch.bool, device=card)
    got[src.long(), dst.long()] = True
    for lo in range(0, v, 2048):
        d2 = ((pts[lo:lo + 2048, None, :] - pts[None, :, :]) ** 2).sum(-1)
        want = d2 < r2
        want[torch.arange(want.shape[0]), torch.arange(lo, lo + 2048)] = False
        assert torch.equal(got[lo:lo + 2048], want)
