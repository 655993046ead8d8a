"""A cell of BENCHMARK.json and the files it is made of, found by name.

Everything that belongs to one configuration, traffic mix, job kind,
generator or per-layer metric is a file of its own under `portbench/`:

    configs/<config>.json   generator kind and parameters, weights, source
    gen/<generator>.py      draws the edge list on the card from a seed
    mixes/<traffic>.json    the job kinds of the closed loop and their params
    jobs/<kind>.py          the port's entry for one job, its work count
    ref/<kind>.py           the plain reference of that kind and its check
    metrics/<metric>.py     reads one per-layer metric of a traced run; a
                            metric a.b without a file of its own is read
                            by metrics/a.py

All of them are looked up under one root (the checkout), so a later change
adds a cell, a mix or a metric by adding files only.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType

PKG = "portbench"


def load_module(path: Path) -> ModuleType:
    """The Python file at `path` as a module (its name may hold dots)."""
    path = Path(path).resolve()
    if not path.is_file():
        raise FileNotFoundError(path)
    name = f"{PKG}_file_{hashlib.sha1(str(path).encode()).hexdigest()[:12]}"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One workload of BENCHMARK.json with its files loaded."""

    root: Path
    name: str
    chips: int
    config_name: str
    config: dict
    mix_name: str
    mix: dict
    end_to_end: list          # BENCHMARK.json entries this cell reports
    per_layer: list

    def path(self, *parts: str) -> Path:
        return self.root.joinpath(PKG, *parts)

    def generator(self) -> ModuleType:
        return load_module(self.path("gen", self.config["generator"] + ".py"))

    def job(self, kind: str) -> ModuleType:
        return load_module(self.path("jobs", kind + ".py"))

    def ref(self, kind: str) -> ModuleType:
        return load_module(self.path("ref", self.job(kind).REF + ".py"))

    def metric_reader(self, name: str) -> ModuleType:
        """metrics/<name>.py, else the reader of the name less its last
        dotted part (one reader serving `x.sweep` and `x.traverse`)."""
        path = self.path("metrics", name + ".py")
        if not path.exists() and "." in name:
            path = self.path("metrics", name.rsplit(".", 1)[0] + ".py")
        return load_module(path)

    @property
    def kinds(self) -> list:
        return [j["kind"] for j in self.mix["jobs"]]

    def params(self, kind: str) -> dict:
        for j in self.mix["jobs"]:
            if j["kind"] == kind:
                return dict(j.get("params", {}))
        raise KeyError(kind)


def _reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(root, workload: str) -> Cell:
    """The cell `workload` of <root>/BENCHMARK.json; raises KeyError when
    it has no such cell."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in "
                       f"{root / 'BENCHMARK.json'}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    mix = json.loads((root / PKG / "mixes" / (w["traffic"] + ".json"))
                     .read_text())
    return Cell(root=root, name=workload, chips=int(w["chips"]),
                config_name=w["config"], config=config,
                mix_name=w["traffic"], mix=mix,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, workload)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, workload)])
