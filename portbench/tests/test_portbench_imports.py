"""Nothing the harness runs imports JAX or the JAX package, and its plain
references import nothing of the program. Top-level module names are
compared whole: the port's name begins with the JAX package's."""
import json
import subprocess
import sys

from conftest import REPO

PROBE = """
import json, sys
from pathlib import Path
import portbench.run, portbench.harness, portbench.control
from portbench.cell import load_module
from portbench.harness import forbidden_modules
for sub in {subs!r}:
    for f in sorted((Path('portbench') / sub).glob('*.py')):
        load_module(f)
print(json.dumps({{"forbidden": forbidden_modules(),
                  "port": sorted(m for m in sys.modules if m.split('.')[0]
                                 == 'vectorgraphlibrary_tpu_torch')}}))
"""


def _probe(subs):
    out = subprocess.run([sys.executable, "-c", PROBE.format(subs=subs)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_harness_loads_no_jax():
    got = _probe(["gen", "jobs", "ref", "metrics"])
    assert got["forbidden"] == []


def test_the_references_import_nothing_of_the_program():
    got = _probe(["ref"])
    assert got["forbidden"] == [] and got["port"] == []


def test_a_run_of_the_port_loads_no_jax(tiny_root):
    code = ("from portbench.harness import run_cell, forbidden_modules; "
            "run_cell('.', 'tiny-cl.traverse', 1, 0.1, True, 'cpu', "
            "log=lambda m: None); print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny_root,
                         capture_output=True, text=True, timeout=300,
                         env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole():
    from portbench import harness
    added = ["vectorgraphlibrary_tpu_torch_x.y", "jaxlibrary", "jax.numpy",
             "vectorgraphlibrary_tpu.ops"]
    try:
        for name in added:
            sys.modules.setdefault(name, sys)
        found = harness.forbidden_modules()
        assert "jax.numpy" in found and "vectorgraphlibrary_tpu.ops" in found
        assert "jaxlibrary" not in found
        assert "vectorgraphlibrary_tpu_torch_x.y" not in found
    finally:
        for name in added:
            if sys.modules.get(name) is sys:
                del sys.modules[name]
