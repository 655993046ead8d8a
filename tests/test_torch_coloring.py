"""PyTorch port, graph coloring: vgl_coloring against the JAX package's on
RMAT-10, RU-9 and a graph with self-loops, with and without core extraction,
and on the 96-clique that needs more colors than one window holds (colors
and round counts equal exactly, verify_colors 0); the uint32 helpers on
int64 against numpy's uint32; the core pass against the JAX package's; and
the app's CLI contract. The JAX package runs as its own tests run it
(tests/conftest.py: routed paths, Pallas in interpret mode)."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorgraphlibrary_tpu.graph.device import import_graph as jimport_graph
from vectorgraphlibrary_tpu.io.edges_container import EdgesContainer
from vectorgraphlibrary_tpu.models import coloring as jcol

from vectorgraphlibrary_tpu_torch.graph.device import import_graph as timport_graph
from vectorgraphlibrary_tpu_torch.models import coloring as tcol
from vectorgraphlibrary_tpu_torch.utils.verify import verify_colors

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPHS = ["small_rmat", "small_ru", "selfloops"]
# mode -> vgl_coloring kwargs (ec is added for the core modes); threshold 16
# makes a core on RMAT-10 (tests/test_algorithms2.py)
MODES = {"plain": {}, "core": dict(core_threshold=16),
         "seed": dict(seed=3, max_colors=32)}


def _selfloop_graph():
    """tests/test_torch_host.py's random graph with 50 self-loops."""
    rng = np.random.default_rng(0)
    v, e = 900, 9000
    src = rng.integers(0, v, e).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    src[:50] = dst[:50]
    return EdgesContainer(src, dst, v)


def _clique(n=96):
    s, d = np.meshgrid(np.arange(n), np.arange(n))
    keep = s != d
    return EdgesContainer(s[keep].astype(np.int32), d[keep].astype(np.int32), n)


@pytest.fixture(scope="module")
def graphs(request):
    cache = {}

    def get(name):
        if name not in cache:
            ec = {"selfloops": _selfloop_graph, "clique": _clique}.get(name)
            ec = ec() if ec else request.getfixturevalue(name)
            cache[name] = (ec, jimport_graph(ec), timport_graph(ec, device="cpu"))
        return cache[name]
    return get


def _check(got, want, ec, tg):
    colors, rounds = got
    jcolors, jrounds = want
    assert rounds == jrounds and isinstance(rounds, int)
    assert colors.direction.name == "ORIGINAL"
    assert colors.values.dtype == torch.int32
    np.testing.assert_array_equal(colors.values.numpy(),
                                  np.asarray(jcolors.values))
    vals = colors.values.numpy()[:tg.v]
    assert vals.min() >= 0
    assert verify_colors(ec, vals) == 0


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("graph", GRAPHS)
def test_coloring_matches_jax(graphs, graph, mode):
    ec, jg, tg = graphs(graph)
    kw = dict(MODES[mode])
    if mode == "core":
        kw["ec"] = ec
    _check(tcol.vgl_coloring(tg, **kw), jcol.vgl_coloring(jg, **kw), ec, tg)


def test_high_chromatic_clique_matches_jax(graphs):
    """96 colors > the 64-color window: the window slides (rounds that keep
    nothing) and every color is distinct."""
    ec, jg, tg = graphs("clique")
    trace = []
    got = tcol.vgl_coloring(tg, trace=trace)
    _check(got, jcol.vgl_coloring(jg), ec, tg)
    vals = got[0].values.numpy()[:96]
    assert len(np.unique(vals)) == 96 and vals.max() >= 64
    assert any(kept == 0 for kept, _ in trace)
    assert len(trace) == got[1] and trace[-1][1] == 0


def test_core_colors_match_jax(graphs):
    ec, _, _ = graphs("small_rmat")
    got = tcol.host_core_colors(ec, 16)
    np.testing.assert_array_equal(got, jcol.host_core_colors(ec, 16))
    assert (got >= 0).any()


def test_round_cap_raises(graphs):
    _, _, tg = graphs("small_rmat")
    with pytest.raises(RuntimeError, match="uncolored"):
        tcol.vgl_coloring(tg, max_rounds=1)


def test_uint32_helpers_match_numpy():
    """_hash32 and the rotate-and-lowest-bit steps on int64 equal numpy's
    uint32 arithmetic, bit 31 and zero words included."""
    rng = np.random.default_rng(1)
    x = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 1, 2**31, 2**32 - 1]

    def np_hash(x):
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(0x7FEB352D)
        x = x ^ (x >> np.uint32(15))
        x = x * np.uint32(0x846CA68B)
        return x ^ (x >> np.uint32(16))
    with np.errstate(over="ignore"):
        want = np_hash(x)
    got = tcol._hash32(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    lsb = x & (~x + np.uint32(1))
    pos = np.where(lsb == 0, 0, np.log2(np.maximum(lsb, 1)).astype(np.int64))
    got = tcol._bit_position(torch.from_numpy(lsb.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), pos)
    bits = tcol._bits_of(torch.ones(32, dtype=torch.bool), torch.arange(32))
    np.testing.assert_array_equal(bits.numpy().view(np.uint32),
                                  np.uint32(1) << np.arange(32, dtype=np.uint32))


def test_seq_coloring_is_a_coloring(graphs):
    ec, _, _ = graphs("small_ru")
    got = tcol.seq_coloring(ec)
    np.testing.assert_array_equal(got, jcol.seq_coloring(ec))
    assert verify_colors(ec, got) == 0


def test_app_cli_contract():
    out = subprocess.run(
        [sys.executable, "-m", "vectorgraphlibrary_tpu_torch.apps.coloring",
         "-s", "9", "-e", "8", "-it", "2", "-check", "-dev", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "AVG_PERF:" in out.stdout
    assert out.stdout.count("error count: 0") == 2
