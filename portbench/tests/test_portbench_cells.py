"""A configuration, a mix, a job kind and a per-layer metric added as files
become a runnable cell, with no edit of a file that is there; the command
refuses to measure without a card or without the program."""
import json
import os
import subprocess
import sys

from portbench.harness import run_cell
from conftest import REPO, add_cell

QUIET = {"log": lambda msg: None}


def test_tiny_cells_run_on_the_cpu_and_give_the_line(tiny_root):
    for cell in ("tiny-kron.sweep", "tiny-cl.traverse"):
        r = run_cell(tiny_root, cell, 2**31 + 11, 0.3, False, "cpu", **QUIET)
        assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                               "device"]
        assert list(r)[-1] == "checks"
        assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 2
        want = {"setup_s"} | ({"pagerank_mteps", "cc_mteps"}
                              if cell.endswith("sweep")
                              else {"bfs_gteps", "sssp_mteps"})
        assert set(r["metrics"]) == want
        assert all(m["value"] > 0 for m in r["metrics"].values())
        assert r["device"]["count"] == 1


def test_added_files_make_a_new_cell(tiny_root):
    pb = tiny_root / "portbench"
    # a job kind: PageRank at 5 iterations, with its own rate
    (pb / "jobs" / "pagerank5.py").write_text(
        (pb / "jobs" / "pagerank.py").read_text()
        .replace('METRIC = "pagerank_mteps"', 'METRIC = "pagerank5_mteps"'))
    # a mix of it alone, and a metric that counts its jobs
    (pb / "mixes" / "pr5.json").write_text(json.dumps({
        "why": "test", "jobs": [{"kind": "pagerank5", "params": {
            "iterations": 5, "damping": 0.85}}],
        "warmup_per_kind": 1, "checked_per_kind": 2, "roots": 0}))
    (pb / "metrics" / "jobs_per_s.py").write_text(
        "def read(run):\n    return len(run.jobs) / run.window_s\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({
        "name": "pagerank5_mteps", "unit": "MTEPS", "better": "higher",
        "bound": 0.05, "source": "host_clock",
        "workloads": ["tiny-kron.pr5"]})
    bench["per_layer"].append({
        "name": "jobs_per_s", "unit": "1/s", "better": "higher",
        "source": "host_clock", "layer": "device", "moves": "pagerank5_mteps",
        "workloads": ["tiny-kron.pr5"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    add_cell(tiny_root, "tiny-kron", "pr5")
    plain = run_cell(tiny_root, "tiny-kron.pr5", 5, 0.3, False, "cpu", **QUIET)
    assert plain["correct"]
    assert set(plain["metrics"]) == {"pagerank5_mteps", "setup_s"}
    traced = run_cell(tiny_root, "tiny-kron.pr5", 5, 0.3, True, "cpu", **QUIET)
    assert traced["correct"] and traced["metrics"]["jobs_per_s"]["value"] > 0
    # no device operation on the CPU: the trace's device readers stay out
    assert set(traced["metrics"]) == {"jobs_per_s"}


def _command(cwd, *args, env=None):
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "graph500-s21.sweep", "--seed", "1", "--seconds", "1", *args],
        cwd=cwd, capture_output=True, text=True, timeout=120,
        env=env or dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_no_result_without_a_card():
    out = _command(REPO)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "needs 1 CUDA card" in out.stderr


def test_no_result_without_the_program(tiny_root):
    """In a directory of only BENCHMARK.json and portbench/, a run fails
    before it prints a line (here driven past the card check on the
    CPU)."""
    code = ("from portbench.harness import run_cell; "
            "run_cell('.', 'tiny-kron.sweep', 1, 0.1, False, 'cpu')")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny_root,
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert out.returncode != 0
    assert "vectorgraphlibrary_tpu_torch" in out.stderr
    assert out.stdout.strip() == ""
