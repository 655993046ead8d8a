"""Where does the CSR pull spend its time on the card? (CUDA only, raises
without a card)

    python -m vectorgraphlibrary_tpu_torch.apps.exp_pull [-s 18] [-e 32]

On RMAT-s (average degree e, seed 42, unweighted), the pull_reduce kernel
over the GATHER CSR with f32 add, device ms per call by torch.profiler (the
mean of 10 launches):
  a) the whole pull with the graph's work units (ops/advance.row_groups);
  b) each degree class alone (its rows of row_ptr, the same threads per row);
  c) the huge class with one warp per row in place of one block;
  d) the longest row alone, with one block;
  e) torch.mv of the CSR tensor (cuSPARSE), the one-call yardstick.
Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import torch

from ..graph.device import import_graph
from ..io import generation
from ..models.bfs import G
from ..ops.advance import row_groups
from ..ops.cuda.pull_reduce import BLOCK, pull_reduce


def _ms(fn, reps: int = 10) -> float:
    """Device time of one call: the kernels' durations by torch.profiler
    over `reps` calls (events would time the host's launches instead, which
    take longer than a small class's kernel)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / reps / 1e3


def measure(scale: int = 18, degree: int = 32, device: str = "cuda") -> dict:
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("exp_pull measures the kernel on a CUDA device")
    ec = generation.rmat(scale, degree, seed=42, weighted=False)
    g = import_graph(ec, device=device)
    dg = g.direction(G)
    x = torch.rand(g.v_pad, device=device)
    groups = row_groups(dg)
    res = {"all": _ms(lambda: pull_reduce(dg.row_ptr, dg.col_idx, x, "add",
                                          True, groups))}
    start = 0
    for end, threads in groups:
        rp = dg.row_ptr[start:end + 1]
        res[f"rows {start}-{end} x{threads}"] = _ms(
            lambda: pull_reduce(rp, dg.col_idx, x, "add", False,
                                ((end - start, threads),)))
        if threads == BLOCK:
            res[f"rows {start}-{end} x32"] = _ms(
                lambda: pull_reduce(rp, dg.col_idx, x, "add", False,
                                    ((end - start, 32),)))
        start = end
    rp = dg.row_ptr[:2]
    res[f"row 0 ({int(rp[1])} edges) x{BLOCK}"] = _ms(
        lambda: pull_reduce(rp, dg.col_idx, x, "add", False, ((1, BLOCK),)))
    e = dg.e
    rows = torch.repeat_interleave(
        torch.arange(g.v_pad, device=device, dtype=torch.int32),
        dg.degrees.long(), output_size=e)
    cols = dg.col_idx[:e]
    a = torch.sparse_csr_tensor(dg.row_ptr, cols, (cols != rows).float(),
                                size=(g.v_pad, g.v_pad))
    res["torch.mv"] = _ms(lambda: torch.mv(a, x))
    return res


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-s", type=int, default=18)
    p.add_argument("-e", type=int, default=32)
    args = p.parse_args()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "ms": measure(args.s, args.e)}))


if __name__ == "__main__":
    main()
