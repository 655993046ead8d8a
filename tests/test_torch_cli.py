"""PyTorch port, the CLI and the format chooser against the JAX package's:
parse_args of both packages on the same argv gives equal VGLConfig fields
(-gen, -no-prim-stats, -format auto and their combinations with -s/-e;
-dev defaults to each package's own device, so argv names it);
FormatAutotuner.choose, its cold-start rule and apply on seeded RMAT and
uniform graphs pick the same configuration; the bundled samples are the JAX
package's; runtime.prepare_graph with -format auto prints the JAX package's
autotuner line and imports the graph in the picked format."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorgraphlibrary_tpu.io import generation as jgeneration
from vectorgraphlibrary_tpu.runtime import cli as jcli
from vectorgraphlibrary_tpu.runtime import runtime as jruntime
from vectorgraphlibrary_tpu.utils import autotuner as jtuner

from vectorgraphlibrary_tpu_torch.io import generation as tgeneration
from vectorgraphlibrary_tpu_torch.runtime import cli as tcli
from vectorgraphlibrary_tpu_torch.runtime import runtime as truntime
from vectorgraphlibrary_tpu_torch.utils import autotuner as ttuner

ARGVS = {
    "gen": ["-gen"],
    "no-prim-stats": ["-no-prim-stats"],
    "format-auto": ["-format", "auto"],
    "format-AUTO": ["-format", "AUTO"],
    "gen-scale": ["-gen", "-s", "11", "-e", "4"],
    "all-three": ["-gen", "-s", "9", "-e", "32", "-no-prim-stats",
                  "-format", "auto"],
    "auto-ru-check": ["-format", "auto", "-ru", "-s", "10", "-check",
                      "-it", "3"],
    "csr-no-stats": ["-format", "csr", "-no-prim-stats", "-e", "8"],
    "none": [],
}


def _fields(cfg) -> dict:
    """Every VGLConfig field, enums by value."""
    return {f.name: getattr(getattr(cfg, f.name), "value",
                            getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("case", list(ARGVS))
def test_parse_args_matches_jax(case):
    argv = ARGVS[case] + ["-dev", "cpu"]
    want = _fields(jcli.parse_args(argv, "pr"))
    got = _fields(tcli.parse_args(argv, "pr"))
    assert got == want
    assert got["prim_stats"] == ("-no-prim-stats" not in argv)
    assert got["autotune_format"] == ("auto" in [a.lower() for a in argv])


def test_gen_is_accepted_and_changes_nothing():
    base = _fields(tcli.parse_args(["-s", "11"]))
    assert _fields(tcli.parse_args(["-gen", "-s", "11"])) == base
    assert tcli.build_parser().parse_args(["-gen"]).gen


def test_format_auto_is_tile_csr_with_the_tuner():
    cfg = tcli.parse_args(["-format", "auto"])
    assert cfg.graph_format.value == "vect_csr" and cfg.autotune_format
    assert not tcli.parse_args([]).autotune_format


# (kind, scale, degree, seed): two seeded RMATs and one uniform graph
GRAPHS = [("rmat", 10, 8, 3), ("rmat", 12, 32, 5), ("ru", 11, 6, 7)]


def _pair(kind, scale, degree, seed):
    fn = "rmat" if kind == "rmat" else "random_uniform"
    return (getattr(jgeneration, fn)(scale, degree, seed=seed),
            getattr(tgeneration, fn)(scale, degree, seed=seed))


@pytest.mark.parametrize("graph", GRAPHS, ids=lambda g: "-".join(map(str, g)))
def test_autotuner_choose_matches_jax(graph):
    jec, tec = _pair(*graph)
    np.testing.assert_array_equal(ttuner.extract_features(tec),
                                  jtuner.extract_features(jec))
    want = jtuner.default_tuner().choose(jec)
    assert ttuner.default_tuner().choose(tec) == want
    assert ttuner.FormatAutotuner._heuristic(tec) \
        == jtuner.FormatAutotuner._heuristic(jec)
    assert ttuner.FormatAutotuner().choose(tec) \
        == jtuner.FormatAutotuner().choose(jec)
    cfg = ttuner.default_tuner().apply(tec, tcli.parse_args(["-format",
                                                             "auto"]))
    jcfg = jtuner.default_tuner().apply(jec, jcli.parse_args(["-format",
                                                              "auto"]))
    assert (cfg.graph_format.value, cfg.huge_degree_threshold,
            cfg.huge_row_chunk) == (jcfg.graph_format.value,
                                    jcfg.huge_degree_threshold,
                                    jcfg.huge_row_chunk)


def test_bundled_samples_are_the_jax_packages(tmp_path):
    with open(ttuner.BUNDLED_SAMPLES) as fp, open(jtuner.BUNDLED_SAMPLES) as fj:
        assert json.load(fp) == json.load(fj)
    tuner = ttuner.default_tuner()
    assert len(tuner.samples) > 0
    path = str(tmp_path / "samples.json")
    tuner.save(path)
    assert ttuner.FormatAutotuner.load(path).samples == tuner.samples
    _, tec = _pair(*GRAPHS[0])
    extra = ttuner.FormatAutotuner()
    extra.add_sample(tec, {"graph_format": "csr", "huge_degree_threshold": 64,
                           "huge_row_chunk": 128})
    assert extra.choose(tec)["graph_format"] == "csr"


@pytest.mark.parametrize("argv", [["-s", "10", "-e", "8"],
                                  ["-s", "9", "-e", "4", "-ru"]])
def test_prepare_graph_with_format_auto_matches_jax(argv, capsys):
    argv = argv + ["-format", "auto", "-dev", "cpu"]
    jec, _, _ = jruntime.prepare_graph(jcli.parse_args(argv))
    want = capsys.readouterr().out
    tec, graph, _ = truntime.prepare_graph(tcli.parse_args(argv),
                                           device="cpu")
    got = capsys.readouterr().out
    assert "autotuner: format=" in want and got == want
    np.testing.assert_array_equal(tec.src_ids, jec.src_ids)
    picked = jtuner.default_tuner().choose(jec)
    assert graph.graph_format.value == picked["graph_format"]
