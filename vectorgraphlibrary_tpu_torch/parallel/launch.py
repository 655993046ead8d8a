"""Run one function on N ranks of a fresh torch.distributed group.

    results = run_ranks("package.module:function", 4, device="cpu",
                        kwargs={"scale": 9}, timeout=120)

Each rank is a new Python process (`python -m
vectorgraphlibrary_tpu_torch.parallel.launch ...`) that imports only the
port and the function's module, joins the group through a file:// store in
a fresh temporary directory (no TCP port to collide with another run),
calls function(rank, world_size, device, **kwargs) and writes the dict of
arrays it returns to that directory. On the CPU a rank runs torch on one
thread. run_ranks raises if any rank exits non-zero or outlives its
timeout, and kills the ranks still running.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_ranks(fn: str, world_size: int, device: str = "cuda",
              kwargs: dict | None = None, backend: str | None = None,
              timeout: float = 600.0) -> list[dict]:
    """Every rank's returned dict of numpy arrays, in rank order. `fn`:
    "module:function", importable from the repository's root. `device`:
    where every rank computes (all ranks of a one-card host share cuda:0);
    `backend`: None follows the device (mesh.init_distributed)."""
    with tempfile.TemporaryDirectory(prefix="vgl_ranks_") as tmp:
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
        if device == "cpu":
            env["OMP_NUM_THREADS"] = "1"
        procs, logs = [], []
        try:
            for rank in range(world_size):
                logs.append(open(os.path.join(tmp, f"rank{rank}.log"), "w+"))
                procs.append(subprocess.Popen(
                    [sys.executable, "-m",
                     "vectorgraphlibrary_tpu_torch.parallel.launch",
                     "--fn", fn, "--rank", str(rank),
                     "--world-size", str(world_size), "--device", device,
                     "--backend", backend or "", "--dir", tmp,
                     "--kwargs", json.dumps(kwargs or {})],
                    cwd=REPO, env=env, stdout=logs[-1],
                    stderr=subprocess.STDOUT))
            _wait(procs, logs, time.monotonic() + timeout)
            texts = []
            for f in logs:
                f.seek(0)
                texts.append(f.read())
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        results = []
        for rank in range(world_size):
            with np.load(os.path.join(tmp, f"rank{rank}.npz")) as z:
                res = {k: z[k] for k in z.files}
            res["log"] = texts[rank]
            results.append(res)
        return results


def _wait(procs: list, logs: list, deadline: float) -> None:
    """Until every rank has exited 0; raises at the first rank that exits
    otherwise (the others would wait for it in a collective) or at the
    deadline."""
    while True:
        codes = [p.poll() for p in procs]
        for rank, code in enumerate(codes):
            if code not in (None, 0):
                logs[rank].seek(0)
                raise RuntimeError(f"rank {rank} of {len(procs)} exited with "
                                   f"{code}:\n{logs[rank].read()}")
        if all(c == 0 for c in codes):
            return
        if time.monotonic() > deadline:
            late = [r for r, c in enumerate(codes) if c is None]
            raise RuntimeError(f"ranks {late} of {len(procs)} still running "
                               "at their time limit")
        time.sleep(0.05)


def _main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="launch")
    p.add_argument("--fn", required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world-size", type=int, required=True)
    p.add_argument("--device", required=True)
    p.add_argument("--backend", default="")
    p.add_argument("--dir", required=True)
    p.add_argument("--kwargs", default="{}")
    args = p.parse_args(argv)
    import torch
    import torch.distributed as dist
    from .mesh import init_distributed
    if args.device == "cpu":
        torch.set_num_threads(1)
    module, name = args.fn.split(":")
    fn = getattr(importlib.import_module(module), name)
    device = init_distributed(
        args.device, init_method=f"file://{os.path.join(args.dir, 'store')}",
        rank=args.rank, world_size=args.world_size,
        backend=args.backend or None)
    try:
        out = fn(args.rank, args.world_size, device, **json.loads(args.kwargs))
        np.savez(os.path.join(args.dir, f"rank{args.rank}.npz"),
                 **{k: np.asarray(v) for k, v in out.items()})
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_main())
