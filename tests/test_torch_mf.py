"""PyTorch port, max-flow: vgl_ford_fulkerson equal to the JAX package's and
to seq_ford_fulkerson, exactly, on deduplicated RMAT-9 graphs with integer
capacities over several (source, sink) pairs, a sink that cannot be reached
(flow 0) included; vgl_mf_bfs_levels equal to the JAX package's for zero and
non-zero flows, and with zero flow to seq_top_down's levels; the trace of
augmentations; and the app's CLI contract. The JAX package runs as
tests/conftest.py sets it up (routed paths, Pallas in interpret mode). The
flow is a sum of integer bottlenecks, exact in f32, so every comparison is
exact; augmenting paths may differ (the port's parent arc is the lowest CSR
slot id, the reference's the lowest route slot id)."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorgraphlibrary_tpu.io import generation as jgeneration
from vectorgraphlibrary_tpu.io.edges_container import EdgesContainer as JEdges
from vectorgraphlibrary_tpu.models import mf as jmf

from vectorgraphlibrary_tpu_torch.io.edges_container import (
    EdgesContainer as TEdges)
from vectorgraphlibrary_tpu_torch.models import bfs as tbfs
from vectorgraphlibrary_tpu_torch.models import mf as tmf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = [1, 2, 3]


@pytest.fixture(scope="module")
def nets():
    """seed -> (JAX container, port container, (source, sink) pairs): RMAT-9
    of degree 6 without self-loops and duplicates, capacities in [1, 20)."""
    cache = {}

    def get(seed):
        if seed not in cache:
            d = jgeneration.rmat(scale=9, avg_degree=6, seed=seed) \
                .remove_self_loops_and_duplicates()
            w = np.random.default_rng(seed).integers(
                1, 20, d.edges_count).astype(np.float32)
            v = d.vertices_count
            indeg = np.bincount(d.dst_ids, minlength=v)
            outdeg = np.bincount(d.src_ids, minlength=v)
            hub = int(np.argmax(outdeg))
            tec = TEdges(d.src_ids, d.dst_ids, v, w)
            # a random source with a path to the app's sink for it
            rng = np.random.default_rng(seed + 100)
            for src in rng.permutation(np.flatnonzero(outdeg > 0)):
                app_sink = int(np.argmax(np.where(np.arange(v) != src, indeg,
                                                  -1)))
                if tmf.seq_ford_fulkerson(tec, int(src), app_sink) > 0:
                    break
            pairs = {
                "hub-to-second-in-hub": (hub, int(np.argsort(-indeg)[1])),
                "random-to-app-sink": (int(src), app_sink),
                "unreachable": (hub, int(np.flatnonzero(
                    (indeg == 0) & (np.arange(v) != hub))[0])),
            }
            cache[seed] = (JEdges(d.src_ids, d.dst_ids, v, w), tec, pairs)
        return cache[seed]
    return get


@pytest.mark.parametrize("pair", ["hub-to-second-in-hub", "random-to-app-sink",
                                  "unreachable"])
@pytest.mark.parametrize("seed", SEEDS)
def test_ford_fulkerson_matches_jax_and_oracle(nets, seed, pair):
    jec, tec, pairs = nets(seed)
    source, sink = pairs[pair]
    trace = []
    got = tmf.vgl_ford_fulkerson(tec, None, source, sink, device="cpu",
                                 trace=trace)
    want = tmf.seq_ford_fulkerson(tec, source, sink)
    assert got == want == jmf.vgl_ford_fulkerson(jec, None, source, sink)
    # one entry per BFS; the last did not reach the sink
    assert trace[-1][1] == 0 and all(arcs > 0 for _, arcs in trace[:-1])
    if pair == "unreachable":
        assert got == 0.0 and len(trace) == 1
    else:
        assert got > 0 and len(trace) > 1
        # BFS-shortest augmenting paths: the path has one arc per level
        assert all(levels >= arcs for levels, arcs in trace)


def test_ford_fulkerson_more_pairs_match_oracle(nets):
    """Twelve random (source, sink) pairs per graph against the oracle (the
    residual structure is built once per container)."""
    for seed in SEEDS:
        _, tec, _ = nets(seed)
        rng = np.random.default_rng(seed)
        for source, sink in rng.integers(0, tec.vertices_count, (12, 2)):
            if source == sink:
                continue
            assert tmf.vgl_ford_fulkerson(tec, None, int(source), int(sink),
                                          device="cpu") \
                == tmf.seq_ford_fulkerson(tec, int(source), int(sink))


def test_ford_fulkerson_source_is_sink(nets):
    _, tec, pairs = nets(1)
    s = pairs["hub-to-second-in-hub"][0]
    assert tmf.vgl_ford_fulkerson(tec, None, s, s, device="cpu") == np.inf


@pytest.mark.parametrize("flow", ["zero", "partial"])
@pytest.mark.parametrize("seed", SEEDS)
def test_mf_bfs_levels_match_jax(nets, seed, flow):
    jec, tec, pairs = nets(seed)
    source = pairs["hub-to-second-in-hub"][0]
    if flow == "zero":
        f = np.zeros(tec.edges_count, np.float32)
    else:
        # some arcs saturated, some reverse arcs opened
        rng = np.random.default_rng(seed)
        f = np.where(rng.random(tec.edges_count) < 0.5, tec.weights,
                     np.floor(tec.weights * rng.random(tec.edges_count)))
        f = f.astype(np.float32)
    got = tmf.vgl_mf_bfs_levels(tec, None, f, source, device="cpu")
    want = jmf.vgl_mf_bfs_levels(jec, None, f, source)
    np.testing.assert_array_equal(got, np.asarray(want))
    if flow == "zero":
        seq = tbfs.seq_top_down(tec, source)     # the source is level 1
        np.testing.assert_array_equal(
            got, np.where(seq < 0, 2**31 - 1, seq))


def test_app_cli_contract():
    out = subprocess.run(
        [sys.executable, "-m", "vectorgraphlibrary_tpu_torch.apps.mf", "-s",
         "10", "-e", "8", "-it", "2", "-check", "-dev", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "AVG_PERF:" in out.stdout
    assert out.stdout.count("error count: 0") == 2
