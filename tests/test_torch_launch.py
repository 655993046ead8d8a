"""PyTorch port, the kernels' one launch path: every C entry of the kernel
sources (csrc/*.cu) has exactly one build.Launcher, made when its wrapper
module is imported, with the stream as its last argument, and no wrapper
reaches the library or the stream another way. The launches themselves
need the card (tests/test_torch_cuda.py)."""
import ctypes
import importlib
import pathlib
import re

import pytest

torch = pytest.importorskip("torch")

from vectorgraphlibrary_tpu_torch.ops.cuda import build

PKG = pathlib.Path(build.__file__).resolve().parents[2]
WRAPPERS = ["and_popcount", "lane_shuffle", "pull_reduce", "pull_rows",
            "push_expand", "route_gather", "scatter_combine"]


def _c_entries():
    """name -> number of arguments of every extern "C" entry in csrc/."""
    out = {}
    for src in sorted((PKG / "csrc").glob("*.cu")):
        for name, args in re.findall(r"^int (vgl_\w+)\(([^)]*)\)",
                                     src.read_text(), re.M):
            out[name] = len(args.split(","))
    return out


def _launchers():
    """Every Launcher the wrapper modules hold, directly or in a dict (as
    itself or first in a tuple), each once."""
    found = {}
    for mod in WRAPPERS:
        m = importlib.import_module(
            f"vectorgraphlibrary_tpu_torch.ops.cuda.{mod}")
        objs = list(vars(m).values())
        for o in list(objs):
            if isinstance(o, dict):
                objs += [v[0] if isinstance(v, tuple) else v
                         for v in o.values()]
        found.update((id(o), o) for o in objs if isinstance(o, build.Launcher))
    return list(found.values())


def test_every_entry_has_one_launcher():
    entries = _c_entries()
    launchers = _launchers()
    names = [lch.name for lch in launchers]
    assert sorted(names) == sorted(entries)          # one each, no other
    for lch in launchers:
        assert len(lch.argtypes) == entries[lch.name]
        assert lch.argtypes[-1] is ctypes.c_void_p   # the stream


@pytest.mark.parametrize("mod", WRAPPERS)
def test_wrappers_launch_only_through_the_helper(mod):
    src = (PKG / "ops" / "cuda" / f"{mod}.py").read_text()
    for other in ("load_library", "CDLL", "current_stream", "cuda_stream",
                  "on_device", "build.entry"):
        assert other not in src, other
