"""Fixtures of the harness's tests: a copy of the benchmark with tiny
cells that run on the CPU, and the card where one is visible."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# tiny stand-ins of the two configurations, as files a later change would
# add: scale 10 and a 3,001-vertex replica
TINY = {
    "tiny-kron": ("graph500-s21", {"scale": 10}),
    "tiny-cl": ("chung-lu-lj-size", {"vertices": 3001, "edges": 42600,
                               "max_degree": 200}),
}


def add_cell(root: Path, config: str, traffic: str) -> str:
    """Add <config>.<traffic> to root's BENCHMARK.json (its end-to-end and
    per-layer metrics too); -> the cell's name."""
    path = root / "BENCHMARK.json"
    bench = json.loads(path.read_text())
    name = f"{config}.{traffic}"
    bench["workloads"].append({"name": name, "config": config,
                               "traffic": traffic, "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and any(w.endswith("." + traffic)
                                    for w in m["workloads"]):
            m["workloads"].append(name)
    path.write_text(json.dumps(bench, indent=1))
    return name


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    """A checkout-like directory: BENCHMARK.json and portbench/ copied,
    plus the tiny configurations as new files and their four cells."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    for name, (base, params) in TINY.items():
        cfg = json.loads((REPO / "portbench" / "configs" / f"{base}.json")
                         .read_text())
        cfg["params"].update(params)
        (tmp_path / "portbench" / "configs" / f"{name}.json").write_text(
            json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "test",
                                 "file": f"portbench/configs/{name}.json",
                                 "reduced": [], "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for name in TINY:
        for traffic in ("sweep", "traverse"):
            add_cell(tmp_path, name, traffic)
    return tmp_path


@pytest.fixture
def card():
    """The CUDA device, or a skip where none is visible."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
