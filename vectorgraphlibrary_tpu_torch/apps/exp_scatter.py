"""Where does the in-place int32 add spend its host time on the card, and
what does the ctypes handle of the kernel library cost per launch? (CUDA
only, raises without a card)

    python -m vectorgraphlibrary_tpu_torch.apps.exp_scatter [--rounds 7]

a) steps(): scatter_combine_ of 2^16 int32 messages (an eighth of them
   dropped) into an int32 [2^20] by add, beside index_add_ of the messages
   that land and Monoid.scatter_at_, in turns (means of 300 calls by CUDA
   events, medians over the rounds: the host's time per call varies between
   rounds by more than the differences sought), then each step alone (means
   of 100 calls, medians of 3): the Launcher with the wrapper's arguments
   (the launch without the checks), the Launcher and the bare ctypes call of
   an entry that returns before launching (n = 0), the raw stream, and the
   tensor reads of the checks. Where a step launches nothing, its time is
   host time. The calls combine into the same target again and again, which
   changes its values but not the work.
b) handles(): the same wrapper, and the smallest route launch (128 slots,
   route_gather_finish without a finish), with their C entries resolved in a
   ctypes.CDLL and in a ctypes.PyDLL of the same library, in turns. A CDLL
   call releases the GIL and takes it again around the entry; a PyDLL call
   keeps it.

The imports are absolute, so the file also runs by its path against another
checkout of the package (PYTHONPATH=<checkout>). Prints the card's name and
power limit, then one JSON line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess

import numpy as np
import torch

from vectorgraphlibrary_tpu_torch.ops import monoid as M
from vectorgraphlibrary_tpu_torch.ops.cuda import build
from vectorgraphlibrary_tpu_torch.ops.cuda import route_gather as rg
from vectorgraphlibrary_tpu_torch.ops.cuda import scatter_combine as scm

SEED = 42


def _events_ms(fn, reps: int) -> float:
    """Mean time of one call over `reps` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _in_turns(calls: dict, rounds: int, reps: int) -> dict:
    runs = {k: [] for k in calls}
    for _ in range(rounds):
        for k, fn in calls.items():
            runs[k].append(_events_ms(fn, reps))
    return {k: statistics.median(r) for k, r in runs.items()}


def inputs(device="cuda"):
    """(target, library target, idx, msg, landing idx as int64, landing
    msg): 2^16 int32 messages into an int32 [2^20], an eighth of them at
    2^20 (dropped), from SEED."""
    rng = np.random.default_rng(SEED)
    v = 1 << 20
    out = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, v, dtype=np.int64)
                           .astype(np.int32)).to(device)
    d = rng.integers(0, v, 1 << 16)
    d[rng.permutation(1 << 16)[:(1 << 16) // 8]] = v
    idx = torch.from_numpy(d.astype(np.int32)).to(device)
    msg = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, 1 << 16,
                                        dtype=np.int64)
                           .astype(np.int32)).to(device)
    keep = idx < v
    return out, out.clone(), idx, msg, idx[keep].long(), msg[keep]


def steps(rounds: int = 7, device="cuda") -> dict:
    """a) of the module doc: ms per call by events."""
    target, lib_target, idx, msg, idx_in, msg_in = inputs(device)
    launch = scm._LAUNCH[torch.int32]
    index = target.get_device()
    tp, ip, mp = target.data_ptr(), idx.data_ptr(), msg.data_ptr()
    n_out, n = target.shape[0], idx.shape[0]
    scm.scatter_combine_(target, idx, msg, "add")    # resolves the entry
    ms = _in_turns({
        "wrapper": lambda: scm.scatter_combine_(target, idx, msg, "add"),
        "index_add_": lambda: lib_target.index_add_(0, idx_in, msg_in),
        "monoid_scatter_at_": lambda: M.ADD.scatter_at_(target, idx, msg)},
        rounds, 300)
    ms.update(_in_turns({
        "launcher": lambda: launch(index, tp, n_out, ip, mp, 0, n, 3),
        "launcher_n0": lambda: launch(index, tp, n_out, ip, mp, 0, 0, 3),
        "ctypes_call_n0": lambda: launch.fn(tp, n_out, ip, mp, 0, 0, 3, 0),
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(index),
        "get_device_x3": lambda: (target.get_device(), idx.get_device(),
                                  msg.get_device()),
        "is_contiguous_x3": lambda: (target.is_contiguous(),
                                     idx.is_contiguous(),
                                     msg.is_contiguous()),
        "data_ptr_x3": lambda: (target.data_ptr(), idx.data_ptr(),
                                msg.data_ptr()),
        "dtype_dim_len_x3": lambda: (target.dtype, target.dim(), len(target),
                                     idx.dtype, idx.dim(), len(idx),
                                     msg.dtype, msg.dim(), len(msg))},
        3, 100))
    ms["checks_and_count"] = ms["wrapper"] - ms["launcher"]
    return ms


def handles(rounds: int = 7, device="cuda") -> dict:
    """b) of the module doc: ms per call by events, for each handle: the
    medians and every round's mean."""
    target, _, idx, msg, _, _ = inputs(device)
    x = torch.arange(128, dtype=torch.int32, device=device)
    ix = torch.arange(127, -1, -1, dtype=torch.int32, device=device)
    k4, route = scm._LAUNCH[torch.int32], rg._PLAIN[torch.int32]
    scm.scatter_combine_(target, idx, msg, "add")    # resolve both entries
    rg.route_gather_finish(x, ix)
    path = build.load_library()._name
    fns = {}
    for kind, dll in (("cdll", ctypes.CDLL), ("pydll", ctypes.PyDLL)):
        lib = dll(path)
        for launcher in (k4, route):
            fn = getattr(lib, launcher.name)
            fn.argtypes, fn.restype = launcher.argtypes, ctypes.c_int
            fns[kind, launcher.name] = fn
    kept = k4.fn, route.fn
    calls = {"k4_wrapper": lambda: scm.scatter_combine_(target, idx, msg,
                                                        "add"),
             "route_128": lambda: rg.route_gather_finish(x, ix)}
    runs = {f"{k}_{kind}": [] for k in calls for kind in ("cdll", "pydll")}
    try:
        for _ in range(rounds):
            for kind in ("cdll", "pydll"):
                k4.fn, route.fn = fns[kind, k4.name], fns[kind, route.name]
                for k, fn in calls.items():
                    runs[f"{k}_{kind}"].append(_events_ms(fn, 300))
    finally:
        k4.fn, route.fn = kept
    return {"median": {k: statistics.median(r) for k, r in runs.items()},
            "rounds": runs}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rounds", type=int, default=7)
    args = p.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi,
                      "library": type(build.load_library()).__name__,
                      "steps_ms": steps(args.rounds),
                      "handles_ms": handles(args.rounds)}))


if __name__ == "__main__":
    main()
