"""PyTorch port, the host tools against the JAX package: the corpus's
local tier, the export formats (byte for byte), the graph analytics,
vertex_array and edge_array_from_flat, the package's top-level names, the
autotuner's sample collection, and the app-contract scripts (run_tests,
print_graph_info, ubench_prims) on the CPU."""
import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

import vectorgraphlibrary_tpu as jvgl
from vectorgraphlibrary_tpu.config import TraversalDirection as JDir
from vectorgraphlibrary_tpu.graph.device import import_graph as jimport_graph
from vectorgraphlibrary_tpu.graph import edges as jedges
from vectorgraphlibrary_tpu.graph import vertices as jvertices
from vectorgraphlibrary_tpu.io import corpus as jcorpus
from vectorgraphlibrary_tpu.io import export as jexport
from vectorgraphlibrary_tpu.io import generation as jgeneration
from vectorgraphlibrary_tpu.utils import analytics as janalytics
from vectorgraphlibrary_tpu.utils import autotuner as jautotuner

import vectorgraphlibrary_tpu_torch as tvgl
from vectorgraphlibrary_tpu_torch.apps import print_graph_info, run_tests
from vectorgraphlibrary_tpu_torch.apps import ubench_prims
from vectorgraphlibrary_tpu_torch.config import TraversalDirection, VGLConfig
from vectorgraphlibrary_tpu_torch.graph.device import import_graph
from vectorgraphlibrary_tpu_torch.graph import edges, vertices
from vectorgraphlibrary_tpu_torch.io import corpus, export, generation
from vectorgraphlibrary_tpu_torch.utils import analytics, autotuner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same_edges(a, b):
    assert a.vertices_count == b.vertices_count
    for f in ("src_ids", "dst_ids", "weights"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(x, y)


def test_bundled_graph_equals_reference(tmp_path, monkeypatch):
    """Both packages convert the bundled pydeps graph from its .el.gz into
    an empty cache, with equal arrays, and then read it back."""
    monkeypatch.setenv("VGL_GRAPH_DIR", str(tmp_path / "t"))
    name, ec = corpus.bundled_graph("pydeps")
    monkeypatch.setenv("VGL_GRAPH_DIR", str(tmp_path / "j"))
    jname, jec = jcorpus.bundled_graph("pydeps")
    assert name == jname == "pydeps"
    assert (ec.vertices_count, ec.edges_count) == (30107, 221730)
    _same_edges(ec, jec)
    assert os.path.exists(tmp_path / "t" / "pydeps.el_container")
    monkeypatch.setenv("VGL_GRAPH_DIR", str(tmp_path / "t"))
    _same_edges(corpus.bundled_graph("pydeps")[1], ec)
    assert corpus.BUNDLED == jcorpus.BUNDLED
    assert corpus.KONECT_GRAPHS == jcorpus.KONECT_GRAPHS
    assert corpus.bundled_graph("nope") == ("nope", None)


def test_local_corpus_tier(tmp_path, monkeypatch, capsys):
    """A KONECT file placed in the cache is found by name, converted once to
    an .el_container that either package reads; nothing is downloaded."""
    monkeypatch.setenv("VGL_GRAPH_DIR", str(tmp_path))
    assert corpus.graph_dir() == str(tmp_path)
    assert corpus.load("road-texas", fetch=False) is None
    assert corpus.load("road-texas") is None           # asks download: None
    assert corpus.download("road-texas") is None
    assert "is not downloaded" in capsys.readouterr().out
    d = tmp_path / "roadNet-TX"
    d.mkdir()
    rng = np.random.default_rng(5)
    pairs = rng.integers(1, 60, (300, 2))
    (d / "out.roadNet-TX").write_text(
        "% sym unweighted\n" + "\n".join(f"{a} {b}" for a, b in pairs) + "\n")
    want = jcorpus.load("road-texas", fetch=False)
    os.unlink(tmp_path / "road-texas.el_container")
    got = corpus.load("road-texas", fetch=False)
    _same_edges(got, want)
    assert os.path.exists(tmp_path / "road-texas.el_container")
    name, cached = corpus.any_cached_graph()
    assert name == "road-texas"
    _same_edges(cached, want)
    _same_edges(jcorpus.any_cached_graph()[1], want)


def test_any_cached_graph_falls_back_to_bundled(tmp_path, monkeypatch):
    monkeypatch.setenv("VGL_GRAPH_DIR", str(tmp_path))
    monkeypatch.setattr(corpus, "BUNDLED", ["pydeps"])
    name, ec = corpus.any_cached_graph()
    assert name == "pydeps" and ec.edges_count == 221730


@pytest.fixture(scope="module")
def small_ec():
    return generation.rmat(4, 3, seed=2)          # 16 vertices, weighted


EXPORTS = {
    "graphviz": lambda m, ec, p: m.save_to_graphviz_file(ec, p),
    "graphviz labels": lambda m, ec, p: m.save_to_graphviz_file(
        ec, p, labels=np.arange(ec.vertices_count) % 3),
    "ligra": lambda m, ec, p: m.export_to_ligra_text_unweighted(ec, p),
    "edges list": lambda m, ec, p: m.export_to_edges_list(ec, p),
    "edges list weighted": lambda m, ec, p: m.export_to_edges_list(
        ec, p, weighted=True),
}


@pytest.mark.parametrize("kind", list(EXPORTS))
def test_export_files_equal_reference(tmp_path, small_ec, kind):
    EXPORTS[kind](export, small_ec, str(tmp_path / "port"))
    EXPORTS[kind](jexport, small_ec, str(tmp_path / "ref"))
    got = (tmp_path / "port").read_bytes()
    assert got and got == (tmp_path / "ref").read_bytes()


def test_graphviz_refuses_large_graphs(tmp_path):
    ec = generation.rmat(6, 2, seed=1)
    assert not export.save_to_graphviz_file(ec, str(tmp_path / "g.dot"))
    assert not os.path.exists(tmp_path / "g.dot")
    assert export.save_to_graphviz_file(ec, str(tmp_path / "g.dot"),
                                        force=True)


@pytest.mark.parametrize("kind,scale,degree,seed", [
    ("rmat", 9, 8, 1), ("ru", 8, 5, 3), ("rmat", 6, 1, 4)])
def test_analytics_equal_reference(kind, scale, degree, seed, capsys):
    ec = generation.generate(kind, scale, degree, seed)
    assert analytics.analyse_degrees(ec) == janalytics.analyse_degrees(ec)
    labels = np.random.default_rng(seed).integers(0, 40, ec.vertices_count)
    assert analytics.component_statistics(labels) == \
        janalytics.component_statistics(labels)
    analytics.print_graph_info(ec)
    janalytics.print_graph_info(ec)
    out = capsys.readouterr().out.splitlines()
    assert out[:3] == out[3:]
    mem, jmem = (analytics.estimate_memory_consumption(ec),
                 janalytics.estimate_memory_consumption(ec))
    for key in ("coo_bytes", "csr_both_directions_bytes",
                "tile_adj_bytes_approx"):
        assert mem[key] == jmem[key], key
    v, e = ec.vertices_count, ec.edges_count
    n_slots = 1 << int(np.ceil(np.log2(max(2 * e, 256))))
    assert mem["route_bytes_approx"] == 24 * v + 10 * n_slots
    csr = analytics.estimate_memory_consumption(
        ec, VGLConfig(graph_format=tvgl.GraphFormat.CSR))
    assert csr["route_bytes_approx"] == 24 * v


def test_print_graph_info_app(capsys):
    print_graph_info.main(["-s", "8", "-e", "4"])
    got = capsys.readouterr().out
    ec = jgeneration.generate("rmat", 8, 4, 42, weighted=False)
    janalytics.print_graph_info(ec)
    print(json.dumps(janalytics.analyse_degrees(ec), indent=1))
    assert got == capsys.readouterr().out


@pytest.fixture(scope="module")
def both_graphs():
    ec = generation.rmat(8, 4, seed=7)
    return ec, jimport_graph(ec), import_graph(ec, device="cpu")


@pytest.mark.parametrize("fill,dtype,jdtype,direction,extra", [
    (3, torch.int32, jnp.int32, "ORIGINAL", ()),
    (-1.5, torch.float32, jnp.float32, "GATHER", ()),
    (True, torch.bool, jnp.bool_, "SCATTER", (3,)),
    (float("inf"), torch.float32, jnp.float32, "GATHER", (2, 2)),
])
def test_vertex_array_equals_reference(both_graphs, fill, dtype, jdtype,
                                       direction, extra):
    _, jg, tg = both_graphs
    got = vertices.vertex_array(tg, fill, dtype,
                                TraversalDirection[direction], extra)
    want = jvertices.vertex_array(jg, fill, jdtype, JDir[direction], extra)
    assert got.direction.name == want.direction.name == direction
    assert got.values.dtype == dtype and got.values.device == tg.device
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    assert tvgl.vertex_array is vertices.vertex_array


@pytest.mark.parametrize("pad_value", [0, -7])
def test_edge_array_from_flat_equals_reference(both_graphs, pad_value):
    _, jg, tg = both_graphs
    rng = np.random.default_rng(pad_value + 10)
    fo = rng.standard_normal(tg.outgoing.e_pad).astype(np.float32)
    fi = rng.standard_normal(tg.incoming.e_pad).astype(np.float32)
    got = edges.edge_array_from_flat(tg, torch.from_numpy(fo),
                                     torch.from_numpy(fi), pad_value=pad_value)
    want = jedges.edge_array_from_flat(jg, jnp.asarray(fo), jnp.asarray(fi),
                                       pad_value=pad_value)
    for d in ("outgoing", "incoming"):
        np.testing.assert_array_equal(getattr(got, d).flat.numpy(),
                                      np.asarray(getattr(want, d).flat))


def _reference_exports():
    with open(jvgl.__file__) as f:
        tree = ast.parse(f.read())
    return sorted(a.asname or a.name for node in tree.body
                  if isinstance(node, ast.ImportFrom)
                  for a in node.names)


def test_package_exports_the_reference_names():
    names = _reference_exports()
    assert len(names) == 29 and "DeviceTimer" in names
    for name in names:
        got, want = getattr(tvgl, name), getattr(jvgl, name)
        assert type(got).__name__ == type(want).__name__, name
        if hasattr(want, "__name__") and not name.endswith("_api"):
            assert got.__name__.rsplit(".", 1)[-1] == \
                want.__name__.rsplit(".", 1)[-1], name
    assert tvgl.__version__ == jvgl.__version__


def test_package_import_builds_no_kernel():
    probe = ("import sys, vectorgraphlibrary_tpu_torch as p\n"
             "from vectorgraphlibrary_tpu_torch.ops.cuda import build\n"
             "maps = open('/proc/self/maps').read()\n"
             "print(build._lib is None, 'libvgl' in maps, "
             "any(m == 'jax' or m.startswith('jax.') for m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "False", "False"]


def test_generate_learning_data_equals_reference():
    kw = dict(scales=(8,), edge_factors=(4, 8), seeds=(0, 1))
    got, want = (autotuner.generate_learning_data(**kw),
                 jautotuner.generate_learning_data(**kw))
    assert len(got) == len(want) == 8
    assert got == want


def test_collect_samples_on_cpu(tmp_path, capsys):
    out = str(tmp_path / "s" / "samples.json")
    tuner = autotuner.collect_samples(scales=(8,), edge_factors=(4,),
                                      thresholds=(128, 1024), pr_iters=2,
                                      out_path=out, device="cpu")
    assert len(tuner.samples) == 2                    # rmat-8-4, ru-8-4
    for (feats, best), kind in zip(tuner.samples, ("rmat", "ru")):
        ec = generation.generate(kind, 8, 4, 0)
        assert feats == autotuner.extract_features(ec).tolist()
        assert best["huge_degree_threshold"] in (128, 1024)
        assert best["graph_format"] == "vect_csr"
    assert autotuner.FormatAutotuner.load(out).samples == \
        json.loads(json.dumps(tuner.samples))
    assert capsys.readouterr().out.count("thr=") == 4


def test_run_tests_verify_on_cpu(tmp_path):
    out = str(tmp_path / "h" / "res")
    rc = run_tests.main(["--verify", "--tier", "tiny", "--apps", "pr,bfs",
                         "--cpu", "--out", out])
    assert rc == 0
    with open(out + ".json") as f:
        rows = json.load(f)
    assert [(r["app"], r["graph"], r["status"]) for r in rows] == [
        ("pr", "rmat-12", "PASS"), ("pr", "ru-12", "PASS"),
        ("bfs", "rmat-12", "PASS"), ("bfs", "ru-12", "PASS")]
    with open(out + ".csv") as f:
        assert f.readline().strip() == "app,graph,mode,status,wall_s"
    assert run_tests.DEFAULT_OUT.startswith(
        os.path.join(REPO, ".cache", "torch_harness"))
    assert run_tests.APPS == ["bfs", "pr", "sssp", "cc", "sswp", "hits",
                              "coloring", "scc", "lp", "rw", "tc", "mf"]


def test_run_tests_benchmark_on_cpu(monkeypatch):
    """--benchmark's rows (on one scale-10 graph: the tiers' graphs are
    what --verify runs above): the row exists and its AVG_PERF line was
    parsed. The app prints MTEPS with two decimals (the JAX package's
    format), so a slow host can print 0.00: the contract is a parsed
    number, not the host's speed. The app runs on one thread, so that
    parallel test workers do not oversubscribe the cores."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rows = run_tests.do_benchmark(["pr"], [("ru", 10, 8)], 300, 1,
                                  ["-dev", "cpu"])
    assert [(r["mode"], r["app"], r["graph"]) for r in rows] == [
        ("benchmark", "pr", "ru-10")]
    assert isinstance(rows[0]["mteps"], float)
    assert rows[0]["mteps"] >= 0
    assert rows[0]["wall_s"] > 0


@pytest.mark.parametrize("out, want", [
    ("AVG_PERF: 0.10 MTEPS", 0.10),
    ("inner wall  77.72\nAVG_PERF: 0.00 MTEPS\n", 0.0),
    ("AVG_PERF: 1234.56 MTEPS\nerror count: 0", 1234.56),
    ("error count: 0\nno perf line", None),
    ("", None)])
def test_parse_avg_perf(out, want):
    assert run_tests.parse_avg_perf(out) == want


def test_run_tests_real_tier_lists_the_corpus(tmp_path, monkeypatch):
    monkeypatch.setenv("VGL_GRAPH_DIR", str(tmp_path))
    monkeypatch.setattr(corpus, "BUNDLED", ["pydeps"])
    rows = run_tests.real_graph_corpus()
    assert rows == [("load", str(tmp_path / "pydeps.el_container"),
                     "pydeps")]
    assert run_tests.real_graph_corpus(["other"]) == []
    assert run_tests.graph_args(*rows[0]) == ["-load", rows[0][1]]
    assert run_tests._label(*rows[0]) == "pydeps"


def test_run_tests_scaling_on_cpu(tmp_path, monkeypatch):
    """--scaling --cpu: apps/scaling.py's sweep over 1 and 2 gloo ranks at
    scale 9, one exported row per rank count."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = str(tmp_path / "s" / "res")
    rc = run_tests.main(["--scaling", "--cpu", "--devices", "1,2",
                         "--scale", "9", "--it", "2", "--out", out])
    assert rc == 0
    with open(out + ".json") as f:
        rows = json.load(f)
    assert [(r["mode"], r["status"], r["devices"], r["scale"])
            for r in rows] == [("scaling", "PASS", 1, 9),
                               ("scaling", "PASS", 2, 9)]
    assert all(r["device"] == "cpu" and r["edges"] == 2**9 * 16
               and r["s_per_iter"] > 0 and r["efficiency"] > 0
               for r in rows)
    assert rows[0]["efficiency"] == 1.0
    with open(out + ".csv") as f:
        assert "efficiency" in f.readline()


def test_scaling_app_json_line():
    """apps/scaling.py --cpu --devices 1,2: its last line is the reference's
    JSON object, with the ranks' device."""
    r = subprocess.run([sys.executable, "-m",
                        "vectorgraphlibrary_tpu_torch.apps.scaling", "--cpu",
                        "--devices", "1,2", "-s", "9", "--iters", "2",
                        "--weak"],
                       capture_output=True, text=True, timeout=300, cwd=REPO,
                       env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stdout + r.stderr
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["mode"] == "weak" and res["virtual_mesh"] is True
    assert res["device"] == "cpu"
    assert [(x["devices"], x["scale"], x["edges_per_device"])
            for x in res["results"]] == [(1, 9, 2**9 * 16),
                                         (2, 10, 2**10 * 16 // 2)]
    assert res["results"][0]["efficiency"] == 1.0
    assert all(x["mteps"] > 0 for x in res["results"])


def test_ubench_prims_rows_on_cpu():
    """The sweep's rows are the JAX script's; each row's time is the op's
    time less the empty op's, never negative."""
    res = ubench_prims.run(k=1, device="cpu")
    assert res["device"] == "cpu" and res["k"] == 1
    rows = {k: v for k, v in res.items() if isinstance(v, dict)}
    assert sorted(rows) == sorted([
        "gather_elem_2e17", "gather_elem_sorted_2e17",
        "gather_rows_32768x32", "gather_rows_32768x128",
        "gather_rows_32768x1024", "take_along_axis_1024x1024",
        "scatter_max_2e17_into_2e20", "scatter_max_2e15_into_2e15",
        "scatter_rows_32768x32", "sort_131072", "sort_kv_131072",
        "sort_1048576", "sort_kv_1048576", "cumsum_131072",
        "cummax_131072", "cumsum_1048576", "cummax_1048576",
        "searchsorted_2e17_in_2e20"])
    assert all(r["ms"] >= 0 and r["ns_per_elem"] >= 0 for r in rows.values())
