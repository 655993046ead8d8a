"""PyTorch port, the slice end to end: PageRank against the JAX package on
RMAT-10 and RU-9 at 20 fixed iterations (rtol 1e-5, atol 1e-8: the same f32
recurrence, with per-row sums taken in another order), the port's oracle
against its ranks and against the JAX oracle, and the app's CLI contract."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorgraphlibrary_tpu.graph.device import import_graph as jimport_graph
from vectorgraphlibrary_tpu.graph.vertices import as_original_numpy as jas_original
from vectorgraphlibrary_tpu.models import pr as jpr

from vectorgraphlibrary_tpu_torch.graph.device import import_graph as timport_graph
from vectorgraphlibrary_tpu_torch.graph.vertices import as_original_numpy as tas_original
from vectorgraphlibrary_tpu_torch.models import pr as tpr
from vectorgraphlibrary_tpu_torch.ops.cuda import route_gather as rg
from vectorgraphlibrary_tpu_torch.utils.verify import verify_ranking_results

ITERS = 20
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("graph", ["small_rmat", "small_ru"])
def test_page_rank_matches_jax(graph, request):
    ec = request.getfixturevalue(graph)
    jg = jimport_graph(ec)
    tg = timport_graph(ec, device="cpu")
    jr, jit = jpr.vgl_page_rank(jg, max_iterations=ITERS, use_convergence=False)
    tr, tit = tpr.vgl_page_rank(tg, max_iterations=ITERS, use_convergence=False)
    assert tit == jit == ITERS
    np.testing.assert_allclose(tr.values.numpy(), np.asarray(jr.values),
                               rtol=1e-5, atol=1e-8)
    got = tas_original(tr, tg)
    np.testing.assert_allclose(got, jas_original(jr, jg), rtol=1e-5, atol=1e-8)
    want = tpr.seq_page_rank(ec, max_iterations=ITERS, use_convergence=False)
    assert verify_ranking_results(got, want) == 0
    # np.bincount in place of np.add.at: the same f64 oracle
    np.testing.assert_allclose(
        want, jpr.seq_page_rank(ec, max_iterations=ITERS,
                                use_convergence=False), rtol=1e-6)


def test_page_rank_convergence_stops_early(small_rmat):
    tg = timport_graph(small_rmat, device="cpu")
    r, iters = tpr.vgl_page_rank(tg, max_iterations=500, use_convergence=True,
                                 convergence_factor=1e-5)
    assert 0 < iters < 500
    want = tpr.seq_page_rank(small_rmat, max_iterations=500,
                             convergence_factor=1e-5)
    assert verify_ranking_results(tas_original(r, tg), want) == 0


def test_cpu_run_launches_no_kernel(small_ru):
    rg.route_gather_finish.launches = 0
    tg = timport_graph(small_ru, device="cpu")
    tpr.vgl_page_rank(tg, max_iterations=2, use_convergence=False)
    assert rg.route_gather_finish.launches == 0


def test_app_cli_contract():
    out = subprocess.run(
        [sys.executable, "-m", "vectorgraphlibrary_tpu_torch.apps.pr", "-s",
         "10", "-e", "8", "-it", "2", "-check", "-dev", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "AVG_PERF:" in out.stdout
    assert out.stdout.count("error count: 0") == 2
