"""PyTorch port: no module of the port (nor chip_smoke.py) imports jax or the
JAX package, and running the slice on the CPU neither loads the JAX package's
native library nor launches a kernel."""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import vectorgraphlibrary_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from vectorgraphlibrary_tpu_torch.io import generation
from vectorgraphlibrary_tpu_torch.graph.device import import_graph
from vectorgraphlibrary_tpu_torch.models import pr
from vectorgraphlibrary_tpu_torch.ops.cuda import route_gather as rg
g = import_graph(generation.rmat(9, 4, seed=1, weighted=False), device="cpu")
pr.vgl_page_rank(g, max_iterations=2, use_convergence=False)
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "jaxlib" or m.startswith("jaxlib.")
       or m == "vectorgraphlibrary_tpu" or m.startswith("vectorgraphlibrary_tpu.")]
maps = open("/proc/self/maps").read() if sys.platform == "linux" else ""
print("MODULES", len(names))
print("BAD", bad)
print("NATIVE", "libvgl_native" in maps)
print("LAUNCHES", rg.route_gather_finish.launches)
"""


def test_port_never_imports_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = dict(ln.split(" ", 1) for ln in out.stdout.splitlines()
                 if ln.split(" ", 1)[0] in ("MODULES", "BAD", "NATIVE",
                                            "LAUNCHES"))
    assert int(lines["MODULES"]) >= 20
    assert lines["BAD"] == "[]"
    assert lines["NATIVE"] == "False"
    assert lines["LAUNCHES"] == "0"
