"""PyTorch port, the large tier's apps on the CPU: apps/bench_scale25.py
(streamed) and apps/bench_s22w_resident.py (resident) with -dev cpu on a
scale-13 artifact of apps/build_scale25.py. Each emits one JSON line per
row with the rows' fields, writes no tracked file (git status is the same
before and after), and exits 1 with a JSON note where the artifact is
missing, as the JAX package's apps do. Also: `run_tests --tier xlarge`
takes the tier's 3600 s timeout (without running the tier), the apps'
entry points default to the card, and the resident PageRank row's timed
calls get their degree constants already on the graph's device."""
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorgraphlibrary_tpu_torch.apps import (bench_s22w_resident,
                                               bench_scale25, run_tests)
from vectorgraphlibrary_tpu_torch.models import cc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE, DEGREE, SHARDS = 13, 8, 4
ENV = dict(VGL_S25_SCALE=str(SCALE), VGL_S25_DEGREE=str(DEGREE),
           VGL_S25_SHARDS=str(SHARDS), VGL_S25_WORKERS="2")


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    path = tmp_path_factory.mktemp("tier")
    r = subprocess.run(
        [sys.executable, "-m", "vectorgraphlibrary_tpu_torch.apps.build_scale25"],
        cwd=REPO, env=dict(os.environ, VGL_S25_CACHE=str(path), **ENV),
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    summary = json.loads(r.stdout.strip().splitlines()[-1])
    assert summary["e"] == DEGREE << SCALE and summary["bytes_on_disk"] > 0
    return str(path)


def _tracked_changes() -> str:
    r = subprocess.run(["git", "status", "--porcelain"], cwd=REPO,
                       capture_output=True, text=True)
    if r.returncode != 0:        # not a git checkout: list the root's files
        return "\n".join(sorted(f"{n} {os.path.getmtime(os.path.join(REPO, n))}"
                                for n in os.listdir(REPO)))
    return r.stdout


def _rows(out: str) -> dict:
    rows = [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]
    return {r["metric"]: r for r in rows}


APPS = {"streamed": bench_scale25, "resident": bench_s22w_resident}


@pytest.mark.parametrize("app", list(APPS))
def test_app_rows_on_the_cpu(cache, app, monkeypatch, capsys):
    for k, val in ENV.items():
        monkeypatch.setenv(k, val)
    monkeypatch.setenv("VGL_S25_CACHE", cache)
    before = _tracked_changes()
    assert APPS[app].main(["-dev", "cpu"]) == 0
    assert _tracked_changes() == before
    rows = _rows(capsys.readouterr().out)
    s = f"rmat{SCALE}"
    want = {f"pagerank_{s}_mteps", f"sssp_{s}_mteps", f"cc_{s}_mteps",
            f"bfs_msbfs_{s}_gteps"}
    want |= ({f"hits_{s}_mteps", "streamed_copy"} if app == "streamed"
             else {"resident_load"})
    assert set(rows) == want
    for r in rows.values():
        assert r["value"] > 0 and r["device"] == "cpu" and r["scale"] == SCALE
    ec_consts = np.load(os.path.join(cache, f"{s}_{DEGREE}_slimw.prconsts.npz"))
    assert rows[f"sssp_{s}_mteps"]["source"] == int(np.argmax(np.where(
        ec_consts["rev"] > 0, 1 / np.maximum(ec_consts["rev"], 1e-12), 0)))
    assert abs(rows[f"pagerank_{s}_mteps"]["ranks_sum"] - 1.0) < 1e-3
    assert rows[f"bfs_msbfs_{s}_gteps"]["edges_traversed"] > 0
    if app == "streamed":
        assert rows[f"sssp_{s}_mteps"]["sweeps"] == \
            rows[f"sssp_{s}_mteps"]["iters"]
        assert rows[f"pagerank_{s}_mteps"]["peak_resident"] == 1
    from vectorgraphlibrary_tpu_torch.io import generation
    ec = generation.rmat(SCALE, DEGREE, seed=42, weighted=True)
    assert rows[f"cc_{s}_mteps"]["components"] == len(np.unique(cc.seq_cc(ec)))


@pytest.mark.parametrize("app", list(APPS))
def test_app_without_an_artifact_exits_1(app, tmp_path, monkeypatch,
                                         capsys):
    monkeypatch.setenv("VGL_S25_CACHE", str(tmp_path))
    assert APPS[app].main(["-dev", "cpu"]) == 1
    note = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "no persisted graph" in note["note"]


def test_xlarge_tier_takes_its_timeout():
    assert run_tests.TIERS["xlarge"] == [("rmat", 22, 16)]
    assert run_tests.timeout_for("xlarge", run_tests.DEFAULT_TIMEOUT) == 3600
    assert run_tests.timeout_for("xlarge", 42) == 42
    assert run_tests.timeout_for("large", run_tests.DEFAULT_TIMEOUT) == \
        run_tests.DEFAULT_TIMEOUT


def test_entry_points_default_to_the_card(cache, monkeypatch):
    """The apps run on the card unless -dev says otherwise, and without a
    card they raise (nothing falls back to the CPU)."""
    for fn in (bench_scale25.run, bench_s22w_resident.run):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    for app in APPS.values():
        assert app.parser().parse_args([]).dev == "cuda"
    if not torch.cuda.is_available():
        for k, val in ENV.items():
            monkeypatch.setenv(k, val)
        monkeypatch.setenv("VGL_S25_CACHE", cache)
        for app in APPS.values():
            with pytest.raises((RuntimeError, AssertionError)):
                app.main([])


def test_resident_pagerank_copies_nothing_per_call(cache, monkeypatch,
                                                   capsys):
    """The resident PageRank row puts its degree constants on the graph's
    device at v_pad before the warm-up: every call (the warm-up and the
    timed one) gets those same tensors, which pr_consts_on keeps as they
    are, so no call pads or copies them."""
    from vectorgraphlibrary_tpu_torch.parallel import sharded
    seen = []
    scan = sharded.pagerank_sharded_scan_consts

    def spy(sg, rev, dmask, iters):
        seen.append((sg, rev, dmask))
        return scan(sg, rev, dmask, iters)
    monkeypatch.setattr(sharded, "pagerank_sharded_scan_consts", spy)
    prefix = os.path.join(cache, f"rmat{SCALE}_{DEGREE}_slimw")
    rows = bench_s22w_resident.run(prefix, "cpu", ("pagerank",))
    capsys.readouterr()
    assert [r["metric"] for r in rows] == ["resident_load",
                                           f"pagerank_rmat{SCALE}_mteps"]
    assert len(seen) == 2
    for sg, rev, dmask in seen:
        for t in (rev, dmask):
            assert isinstance(t, torch.Tensor) and t.device == sg.device
            assert t.numel() == sg.v_pad
        kept = sharded.pr_consts_on(sg, rev, dmask)
        assert kept[0] is rev and kept[1] is dmask
    assert seen[0][1] is seen[1][1] and seen[0][2] is seen[1][2]
