"""PyTorch port on high-diameter graphs, against the plain references of
portbench/ (torch only): the flood-hybrid CC where its flood cannot close
(a 3 x 2,500 grid strip, a random geometric graph from portbench/gen/
rgg.py) gives the reference's partition, a cap that is hit raises, and a
closed flood never opens the link phase's spans; DO-BFS and SSSP on a
random geometric graph equal their references; the generator's edge set
is the brute-force one."""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile

from portbench.cell import load_module
from vectorgraphlibrary_tpu_torch.graph.device import import_graph
from vectorgraphlibrary_tpu_torch.graph.edges import \
    build_edge_array_from_host
from vectorgraphlibrary_tpu_torch.graph.vertices import (VertexArray,
                                                         as_original_numpy)
from vectorgraphlibrary_tpu_torch.io import generation
from vectorgraphlibrary_tpu_torch.io.edges_container import EdgesContainer
from vectorgraphlibrary_tpu_torch.models import bfs, cc, sssp

PB = Path(__file__).resolve().parents[1] / "portbench"
RGG = load_module(PB / "gen" / "rgg.py")
REF = {k: load_module(PB / "ref" / f"{k}.py") for k in ("bfs", "sssp", "cc")}
LINK_SPANS = ("vgl.cc.link", "vgl.cc.compress")


def _strip(width=3, height=2500, permute=False):
    """A width x height grid, each edge both ways, ids row by row or
    shuffled: one component of diameter width + height - 2."""
    ids = np.arange(width * height).reshape(height, width)
    a = np.concatenate([ids[:, :-1].ravel(), ids[:-1, :].ravel()])
    b = np.concatenate([ids[:, 1:].ravel(), ids[1:, :].ravel()])
    if permute:
        perm = np.random.default_rng(1).permutation(width * height)
        a, b = perm[a], perm[b]
    return (np.concatenate([a, b]).astype(np.int32),
            np.concatenate([b, a]).astype(np.int32), width * height)


def _rgg(vertices, seed=22):
    """gen/rgg.py's graph, its ids shuffled as the harness's --seed does."""
    src, dst, v = RGG.edges({"vertices": vertices, "radius_factor": 0.55},
                            seed, "cpu")
    perm = torch.randperm(v, generator=torch.Generator().manual_seed(seed))
    return (perm[src.long()].int().numpy(), perm[dst.long()].int().numpy(),
            v)


def _graph(src, dst, v):
    return import_graph(EdgesContainer(src, dst, v), device="cpu",
                        build_route=False)


def _mismatched(labels, src, dst, v):
    want = REF["cc"].solve(torch.from_numpy(src), torch.from_numpy(dst),
                           None, v, None, {})
    return REF["cc"].compare(labels.values[:v], want)["cc_mismatched"]


# (graph, vgl_cc_hybrid's arguments), each with the count of vertices that
# the hook-min fallback of the parent design (no link rounds, silent caps)
# left split: the strip with the defaults, whose 1,000 flood levels end
# short of its far end (4,500); the shuffled strip, flood cut at 20 levels
# (2,541); a random geometric graph of 2^14 points, flood cut at 20 levels
# and 40 rounds at most (12,555)
DEEP = {
    "strip-defaults": (lambda: _strip(), {}),
    "strip-shuffled": (lambda: _strip(permute=True), dict(max_flood=20)),
    "rgg-2^14-flood-20": (lambda: _rgg(1 << 14),
                          dict(max_flood=20, max_iterations=40)),
}


@pytest.mark.parametrize("case", list(DEEP))
def test_cc_hybrid_is_right_past_its_flood(case):
    make, kw = DEEP[case]
    src, dst, v = make()
    labels, rounds = cc.vgl_cc_hybrid(_graph(src, dst, v), **kw)
    assert _mismatched(labels, src, dst, v) == 0
    assert 1 <= rounds <= 16                    # link rounds, not levels


@pytest.mark.parametrize("kw", [dict(max_flood=10, max_iterations=2),
                                dict(max_flood=0, max_iterations=0)])
def test_a_cap_that_is_hit_raises(kw):
    src, dst, v = _strip(permute=True)
    with pytest.raises(RuntimeError, match="no fixpoint"):
        cc.vgl_cc_hybrid(_graph(src, dst, v), **kw)


def test_deep_tails_after_a_closed_flood_are_linked():
    """A closed flood over a small hub component, then a strip of 2,500
    rows among the tails: more than _TAIL_HOOKS hooks, so link rounds."""
    s1, d1, v1 = _strip(permute=True)
    src = np.concatenate([s1, [v1, v1 + 1]]).astype(np.int32)
    dst = np.concatenate([d1, [v1 + 1, v1]]).astype(np.int32)
    v = v1 + 2
    labels, rounds = cc.vgl_cc_hybrid(_graph(src, dst, v), hub=v1)
    assert _mismatched(labels, src, dst, v) == 0
    assert cc._TAIL_HOOKS < rounds <= cc._TAIL_HOOKS + 16
    assert int(labels.values[v1]) == int(labels.values[v1 + 1]) == v1


def _span_names(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e.name() for e in prof.profiler.kineto_results.events()
                 if e.name().startswith("vgl.")]


@pytest.mark.parametrize("case", ["rmat-closed", "strip-open"])
def test_link_spans_open_only_where_the_flood_does_not_close(case):
    if case == "rmat-closed":
        ec = generation.rmat(scale=10, avg_degree=8, seed=3)
        g, kw = import_graph(ec, device="cpu", build_route=False), {}
    else:
        g, kw = _graph(*_strip(permute=True)), dict(max_flood=20)
    (_, iters), names = _span_names(lambda: cc.vgl_cc_hybrid(g, **kw))
    links = names.count("vgl.cc.link")
    if case == "rmat-closed":
        assert names.count("vgl.cc.flood") >= 1
        assert names.count("vgl.cc.hook") == iters >= 1
        assert not set(LINK_SPANS) & set(names)
    else:
        # every round compresses, then links; the last link finds the
        # fixpoint
        assert names.count("vgl.cc.flood") == 20
        assert "vgl.cc.hook" not in names
        assert links == names.count("vgl.cc.compress") == iters + 1


@pytest.fixture(scope="module")
def rgg_4096():
    src, dst, v = _rgg(1 << 12, seed=5)
    host = []
    g = import_graph(EdgesContainer(src, dst, v), device="cpu",
                     _host_out=host, build_route=False)
    w = np.random.default_rng(0).uniform(1, 100, len(src)) \
        .astype(np.float32)
    ea = build_edge_array_from_host(w, g, host[0], host[1])
    roots = np.flatnonzero(np.bincount(src, minlength=v))[[0, 777, 2048]]
    return src, dst, v, w, g, ea, [int(r) for r in roots]


@pytest.mark.parametrize("kind", ["bfs", "sssp"])
def test_traversals_equal_their_references(rgg_4096, kind):
    src, dst, v, w, g, ea, roots = rgg_4096
    ref = REF[kind]
    ts, td = torch.from_numpy(src), torch.from_numpy(dst)
    for root in roots:
        if kind == "bfs":
            out = bfs.vgl_bfs_device(g, root)
        else:
            out = sssp.vgl_dijkstra_multi(g, ea, [root])
            out = VertexArray(values=out.values[0], direction=out.direction)
        got = torch.from_numpy(as_original_numpy(out, g))
        want = ref.solve(ts, td, torch.from_numpy(w), v, root, {})
        for name, value in ref.compare(got, want).items():
            assert value <= ref.LIMITS[name], (root, name, value)
    if kind == "bfs":                        # a deep graph: many levels
        assert int(want.max()) > 40


def test_rgg_edges_are_the_brute_force_pairs():
    params = {"vertices": 1 << 10, "radius_factor": 0.55}
    src, dst, v = RGG.edges(params, 2**31 + 9, "cpu")
    pts = RGG.points(params, 2**31 + 9, "cpu")
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    want = (d2 < RGG.radius(params) ** 2) & ~torch.eye(v, dtype=torch.bool)
    e = src.numel() // 2
    assert src.dtype == dst.dtype == torch.int32 and v == 1 << 10
    assert e == int(want.sum()) // 2 > 0
    assert torch.equal(src[e:], dst[:e]) and torch.equal(dst[e:], src[:e])
    got = torch.zeros(v, v, dtype=torch.bool)
    got[src.long(), dst.long()] = True
    assert torch.equal(got, want)
    assert not bool((src == dst).any())
    assert torch.unique(src.long() * v + dst.long()).numel() == 2 * e
