"""Run one cell of BENCHMARK.json once and print its result line.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Exits 2 without printing a result when no
CUDA card is visible or fewer than the cell asks for, and 3 when a module
of JAX or of the JAX package is loaded once the window has closed. Prints
the card's name and power limit, then the result as the last line of
standard output; the numbers the check compared, each beside its limit,
are the last lines of standard error and the last key of the result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    root = Path.cwd()
    import torch
    from .cell import load_cell
    from .harness import forbidden_modules, run_cell, smi
    cell = load_cell(root, args.workload)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"portbench: cell {cell.name} needs {cell.chips} CUDA "
              f"card(s); this machine shows {cards}", file=sys.stderr)
        return 2
    print(f"card: {torch.cuda.get_device_name(0)}; nvidia-smi name, power "
          f"limit: {smi()}", flush=True)
    result = run_cell(root, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", T_START)
    found = forbidden_modules()
    if found:
        print(f"portbench: JAX or the JAX package is loaded: {found}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
