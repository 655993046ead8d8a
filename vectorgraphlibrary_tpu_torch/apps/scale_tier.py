"""What the scale tiers' apps share (apps/build_scale25.py,
apps/bench_scale25.py, apps/bench_s22w_resident.py, and the scale-24 tier's
apps/build_scale24.py and apps/bench_scale24.py): the settings from the
environment, the log, the artifact's stored constants and the JSON rows.
Rows go to stdout only: the apps write no file but the builder's artifact
(under the gitignored .cache/ by default)."""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GENERATORS = ("rmat", "rmat_fast")


def settings(default_scale: int = 25) -> dict:
    """The tier's settings from the environment: VGL_S25_SCALE,
    VGL_S25_DEGREE (32), VGL_S25_SHARDS (8), VGL_S25_WORKERS (2: the
    shards the builder builds at once),
    VGL_S25_CACHE (<repo>/.cache) and VGL_S25_GEN (rmat or rmat_fast), and
    the artifact's prefix {cache}/rmat{S}_{D}_slimw, as the JAX package's
    scripts name them."""
    scale = int(os.environ.get("VGL_S25_SCALE", str(default_scale)))
    degree = int(os.environ.get("VGL_S25_DEGREE", "32"))
    cache = os.environ.get("VGL_S25_CACHE", os.path.join(REPO, ".cache"))
    gen = os.environ.get("VGL_S25_GEN", "rmat")
    if gen not in GENERATORS:
        raise ValueError(f"VGL_S25_GEN={gen!r}: one of {GENERATORS}")
    return {"scale": scale, "degree": degree,
            "shards": int(os.environ.get("VGL_S25_SHARDS", "8")),
            "workers": int(os.environ.get("VGL_S25_WORKERS", "2")),
            "cache": cache, "generator": gen, "partition": "dst-hash",
            "weighted": True,
            "prefix": os.path.join(cache, f"rmat{scale}_{degree}_slimw")}


def settings24() -> dict:
    """The scale-24 tier's settings (the JAX package's apps/build_scale24.py
    and apps/bench_scale24.py): VGL_S24_SCALE (24), VGL_S24_DEGREE (16),
    VGL_S24_CACHE (<repo>/.cache); the graph rmat(seed=42) unweighted, in
    dst % S shards (their count chosen by the builder), and the artifact's
    prefix {cache}/rmat{S}_{D}_slim, as the JAX script names it."""
    scale = int(os.environ.get("VGL_S24_SCALE", "24"))
    degree = int(os.environ.get("VGL_S24_DEGREE", "16"))
    cache = os.environ.get("VGL_S24_CACHE", os.path.join(REPO, ".cache"))
    return {"scale": scale, "degree": degree, "shards": None, "workers": 2,
            "cache": cache, "generator": "rmat", "partition": "dst-mod",
            "weighted": False,
            "prefix": os.path.join(cache, f"rmat{scale}_{degree}_slim")}


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def emit(rec: dict) -> dict:
    print(json.dumps(rec), flush=True)
    return rec


def no_artifact(prefix: str, app: str, builder: str = "build_scale25"
                ) -> bool:
    """True (and a JSON note) where the builder has not written prefix."""
    if os.path.exists(f"{prefix}.meta.json"):
        return False
    emit({"note": f"no persisted graph at {prefix}; run "
          f"python -m vectorgraphlibrary_tpu_torch.apps.{builder} "
          f"first ({app})"})
    return True


def device_label(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


@dataclasses.dataclass(frozen=True)
class Consts:
    """The builder's .prconsts.npz and what the rows derive from it: rev
    and dmask ([v], parallel/sharded.pr_consts), the out-degrees without
    self-loops ([v_pad] f32 on the device, for MS-BFS's traversed edges:
    1 / rev rounded to the integer it stands for, which f32 holds exactly,
    so that the count is exact) and the hub (the largest out-degree),
    SSSP's source and CC's flood root, as the JAX package's apps pick
    them."""
    rev: np.ndarray
    dmask: np.ndarray
    outdeg: torch.Tensor
    hub: int


def load_consts(prefix: str, v_pad: int, device) -> Consts:
    with np.load(f"{prefix}.prconsts.npz") as z:
        rev, dmask = z["rev"], z["dmask"]
    outdeg = np.where(rev > 0, 1.0 / np.maximum(rev, 1e-12), 0.0)
    padded = np.zeros(v_pad, np.float32)
    padded[:len(outdeg)] = np.rint(outdeg)
    return Consts(rev=rev, dmask=dmask,
                  outdeg=torch.from_numpy(padded).to(device),
                  hub=int(np.argmax(outdeg)))


def traversed_per_root(levels: torch.Tensor, outdeg: torch.Tensor) -> list:
    """MS-BFS's traversed edges root by root: the out-degrees (integer
    valued, [v_pad]) of the vertices each row of levels ([k, v_pad],
    reached where > 0) reaches, summed exactly in int64."""
    deg = outdeg.to(torch.int64)
    return [int(torch.where(row > 0, deg, 0).sum()) for row in levels]


def traversed_edges(levels: torch.Tensor, outdeg: torch.Tensor) -> int:
    """MS-BFS's traversed edges over all roots (traversed_per_root)."""
    return sum(traversed_per_root(levels, outdeg))


def smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them ("" on a
    machine without it)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""


def tensor_bytes(obj) -> int:
    """Bytes of every tensor in obj's dataclasses, tuples and lists."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if dataclasses.is_dataclass(obj):
        return sum(tensor_bytes(getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    if isinstance(obj, (tuple, list)):
        return sum(tensor_bytes(x) for x in obj)
    return 0


def timed_call(device: torch.device, fn):
    """(fn(), its seconds by runtime/timer.DeviceTimer, the card's peak
    allocated bytes over the call, or None on the CPU)."""
    from ..runtime.timer import DeviceTimer
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    timer = DeviceTimer(device).start()
    out = fn()
    seconds = timer.stop(out)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    return out, seconds, peak
