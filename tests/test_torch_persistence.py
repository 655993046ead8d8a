"""PyTorch port, persistence: the port reads graphs the JAX package saved
(full files, slim ones with only the word masks, compressed ones, weighted
ones with `eidx`) into plans, flags and tiles equal to its own fresh import,
and PageRank and DO-BFS on them equal the fresh graph's; the JAX package
reads the port's files and gets its own advance result; for an unweighted
graph the two packages write the same file, key by key; the apps load edge
files and preprocess graphs."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from vectorgraphlibrary_tpu.config import TraversalDirection
from vectorgraphlibrary_tpu.graph import persistence as jpersist
from vectorgraphlibrary_tpu.graph.device import import_graph as jimport_graph
from vectorgraphlibrary_tpu.io import generation as jgen
from vectorgraphlibrary_tpu.io.konect import import_konect as jimport_konect
from vectorgraphlibrary_tpu.models import pr as jpr
from vectorgraphlibrary_tpu.ops.advance import advance_pull_value

from vectorgraphlibrary_tpu_torch.graph import persistence
from vectorgraphlibrary_tpu_torch.graph.device import import_graph
from vectorgraphlibrary_tpu_torch.io import generation
from vectorgraphlibrary_tpu_torch.io.edges_container import EdgesContainer
from vectorgraphlibrary_tpu_torch.io.konect import import_konect
from vectorgraphlibrary_tpu_torch.models import bfs, common, pr
from vectorgraphlibrary_tpu_torch.ops.cuda import lane_shuffle as ls

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGE_KEYS = ("in_masks", "out_masks", "lane_idx")
PR_ITERS = 10
# (scale, average degree, seed, weighted)
GRAPHS = {"rmat9": (9, 8, 21, False), "rmat11-weighted": (11, 8, 5, True)}


def _tensors(obj, prefix=""):
    """Flatten a port graph into {path: tensor or scalar}."""
    out = {}
    if isinstance(obj, torch.Tensor):
        out[prefix] = obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            out.update(_tensors(getattr(obj, f.name), f"{prefix}.{f.name}"))
    elif isinstance(obj, (tuple, list)):
        for i, x in enumerate(obj):
            out.update(_tensors(x, f"{prefix}[{i}]"))
    else:
        out[prefix] = obj
    return out


def _assert_graphs_equal(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        if isinstance(ta[k], torch.Tensor):
            assert ta[k].dtype == tb[k].dtype, k
            assert torch.equal(ta[k], tb[k]), k
        else:
            assert ta[k] == tb[k], k


def _slim_copy(src: str, dst: str) -> None:
    """The file as a TPU host saves it: no stage arrays, only the word masks
    and lane_inv."""
    with np.load(src) as z:
        keep = {k: z[k] for k in z.files
                if k.rsplit(".", 1)[-1] not in STAGE_KEYS}
    np.savez(dst, **keep)


@pytest.fixture(scope="module")
def jax_files(tmp_path_factory):
    """name -> (ec, JAX graph, {variant: path}) with variants full
    (uncompressed), compressed and slim."""
    d = tmp_path_factory.mktemp("jax_graphs")
    out = {}
    for name, (scale, deg, seed, weighted) in GRAPHS.items():
        ec = jgen.rmat(scale, deg, seed=seed, weighted=weighted)
        jg = jimport_graph(ec)
        paths = {v: str(d / f"{name}.{v}.npz")
                 for v in ("full", "compressed", "slim")}
        jpersist.save_graph_to_binary_file(jg, paths["full"], compressed=False)
        jpersist.save_graph_to_binary_file(jg, paths["compressed"])
        _slim_copy(paths["full"], paths["slim"])
        out[name] = (ec, jg, paths)
    return out


@pytest.fixture(scope="module")
def fresh(jax_files):
    return {name: import_graph(EdgesContainer(ec.src_ids, ec.dst_ids,
                                              ec.vertices_count),
                               device="cpu")
            for name, (ec, _, _) in jax_files.items()}


@pytest.mark.parametrize("variant", ["full", "compressed", "slim"])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_port_reads_jax_file(jax_files, fresh, name, variant):
    """Every plan's indices and flags, and every tile, equal the port's
    fresh import exactly. On the CPU the loader's lane shuffles run the
    plain version and launch no kernel."""
    _, _, paths = jax_files[name]
    if variant == "slim":
        with np.load(paths["slim"]) as z:
            assert not any(k.endswith(".in_masks") for k in z.files)
            assert "route.mid_words" in z.files
    ls.lane_shuffle.launches = 0
    g = persistence.load_graph_from_binary_file(paths[variant], device="cpu")
    assert ls.lane_shuffle.launches == 0
    _assert_graphs_equal(g, fresh[name])
    assert g.advance_route.flags_fwd is not None


@pytest.mark.parametrize("name", list(GRAPHS))
def test_page_rank_and_bfs_on_a_loaded_jax_file(jax_files, fresh, name):
    ec, jg, paths = jax_files[name]
    g = persistence.load_graph_from_binary_file(paths["slim"], device="cpu")
    got = pr.vgl_page_rank(g, max_iterations=PR_ITERS,
                           use_convergence=False)[0].values
    want = pr.vgl_page_rank(fresh[name], max_iterations=PR_ITERS,
                            use_convergence=False)[0].values
    assert torch.equal(got, want)
    jr = jpr.vgl_page_rank(jg, max_iterations=PR_ITERS,
                           use_convergence=False)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(jr.values), rtol=1e-5,
                               atol=1e-8)
    for s in range(2):
        src = common.select_random_source(ec, seed=s)
        assert torch.equal(bfs.vgl_bfs_device(g, src).values,
                           bfs.vgl_bfs_device(fresh[name], src).values)


def test_port_file_equals_jax_file(jax_files, fresh, tmp_path):
    """Unweighted graph: the same keys, dtypes, shapes and values."""
    _, _, paths = jax_files["rmat9"]
    path = str(tmp_path / "port.npz")
    persistence.save_graph_to_binary_file(fresh["rmat9"], path,
                                          compressed=False)
    with np.load(path) as a, np.load(paths["full"]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_jax_reads_port_file(jax_files, fresh, name, tmp_path):
    """The JAX package's advance on the port's file equals its advance on
    its own fresh graph exactly (as tests/test_persistence.py:20-39)."""
    _, jg, _ = jax_files[name]
    path = str(tmp_path / "port.npz")
    persistence.save_graph_to_binary_file(fresh[name], path)
    jg2 = jpersist.load_graph_from_binary_file(path)
    assert jg2.advance_route.has_flags
    x = jnp.asarray(np.random.default_rng(0).random(jg.v_pad), jnp.float32)
    kw = dict(exclude_self_loops=True, direction=TraversalDirection.GATHER)
    np.testing.assert_array_equal(
        np.asarray(advance_pull_value(jg2, x, "add", **kw)),
        np.asarray(advance_pull_value(jg, x, "add", **kw)))


@pytest.mark.parametrize("compressed", [False, True])
def test_port_round_trip(tmp_path, compressed):
    """A graph with self-loops, huge rows and narrow buckets."""
    rng = np.random.default_rng(0)
    v, e = 900, 9000
    src = rng.integers(0, v, e)
    dst = rng.integers(0, v, e)
    src[:50] = dst[:50]
    dst[50:700] = 3                              # one vertex of in-degree 650
    g = import_graph(EdgesContainer(src, dst, v), device="cpu")
    assert g.incoming.huge is not None
    assert any(b.width < 128 for b in g.outgoing.buckets)
    path = str(tmp_path / "g.npz")
    persistence.save_graph_to_binary_file(g, path, compressed=compressed)
    _assert_graphs_equal(persistence.load_graph_from_binary_file(
        path, device="cpu"), g)


def _rewrite(src: str, dst: str, edit) -> None:
    with np.load(src) as z:
        d = {k: z[k] for k in z.files}
    edit(d)
    np.savez(dst, **d)


def _drop_flags(d):
    d["route.meta"] = d["route.meta"].copy()
    d["route.meta"][4] = 0


def _advance_route_without_words(d):
    """As a route of fewer than 1024 slots is saved: no word masks, so no
    flags."""
    for k in ("route.mid_words", "route.big_words"):
        d.pop(k, None)
    d["route.meta"] = np.asarray([d["route.meta"][0], d["route.meta"][1], 0,
                                  0, 0])


def _old_meta(d):
    d["route.meta"] = d["route.meta"][:4]


def _corrupt_lanes(d):
    d["vroute.lane_inv"] = d["vroute.lane_inv"].copy()
    d["vroute.lane_inv"][0, :2] = d["vroute.lane_inv"][0, 1::-1]


def _no_words_no_stages(d):
    for k in ("vroute.mid_words", "vroute.in_masks"):
        d.pop(k)


def _other_format(d):
    d["format"] = np.asarray(["csr"], dtype="U16")


@pytest.mark.parametrize("edit", [_drop_flags, _advance_route_without_words,
                                  _old_meta, _corrupt_lanes,
                                  _no_words_no_stages, _other_format])
def test_load_rejects_what_it_cannot_run(jax_files, tmp_path, edit):
    """A missing finish flag (has_flags 0, no words, or the older 4-entry
    meta) raises, as do a corrupt lane shuffle, a route with neither
    encoding and another graph format."""
    path = str(tmp_path / "bad.npz")
    _rewrite(jax_files["rmat9"][2]["full"], path, edit)
    with pytest.raises(ValueError):
        persistence.load_graph_from_binary_file(path, device="cpu")


def test_old_meta_layout_loads_vertex_routes(jax_files, fresh, tmp_path):
    """A 4-entry route meta (no has_flags) is read as has_flags 0: vertex
    routes need no flags."""
    path = str(tmp_path / "old.npz")

    def edit(d):
        for p in ("vroute", "vroute_so", "vroute_go"):
            d[f"{p}.meta"] = d[f"{p}.meta"][:4]
    _rewrite(jax_files["rmat9"][2]["full"], path, edit)
    _assert_graphs_equal(persistence.load_graph_from_binary_file(
        path, device="cpu"), fresh["rmat9"])


def test_konect_import_equals_jax(tmp_path):
    path = tmp_path / "g.txt"
    path.write_text("% comment\n# other\n10 20 1.5\n20 30 2\n30 10 0.5\n"
                    "50 10 4\n")
    for directed in (True, False):
        a = import_konect(str(path), directed=directed)
        b = jimport_konect(str(path), directed=directed)
        for f in ("src_ids", "dst_ids", "weights"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert a.vertices_count == b.vertices_count == 4


def _run(args):
    return subprocess.run([sys.executable, "-m", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=300)


def test_apps_load_edges_and_preprocess(tmp_path):
    el = str(tmp_path / "g.el_container")
    npz = str(tmp_path / "g.npz")
    out = _run(["vectorgraphlibrary_tpu_torch.apps.create_vgl_graphs", "-gen",
                "rmat", "-s", "9", "-e", "8", "-file", el, "-preprocess", npz,
                "-dev", "cpu"])
    assert out.returncode == 0, out.stdout + out.stderr
    ec = EdgesContainer.load_from_binary_file(el)
    want = generation.rmat(9, 8, seed=42)
    np.testing.assert_array_equal(ec.src_ids, want.src_ids)
    np.testing.assert_array_equal(ec.weights, want.weights)
    _assert_graphs_equal(persistence.load_graph_from_binary_file(npz, "cpu"),
                         import_graph(want, device="cpu"))
    out = _run(["vectorgraphlibrary_tpu_torch.apps.pr", "-load", el, "-dev",
                "cpu", "-check", "-it", "1"])
    assert out.returncode == 0, out.stdout + out.stderr
    assert "AVG_PERF:" in out.stdout
    assert out.stdout.count("error count: 0") == 1
