"""The control of the check: the plain reference computed in the precision
below the configuration's (ref/<kind>.py's CONTROL), put in the program's
place and judged by the harness's own check, on a cell's own inputs.

    python -m portbench.control --workload <cell> --seeds 11,12,13 [--answers 4]

For each seed it draws the cell's edge list, weights and roots as a run
does, and for each job kind that has a control, the control's answers for
the first `answers` roots (one answer for kinds without roots); the
harness's `_check` judges them as it judges a run's sampled answers. Prints
one JSON line per seed with `correct` and the worst number of each check
beside its limit, and a last line with the smallest control reading of
each check over the seeds. The control has to come out not correct on
every seed: a check it passes cannot tell the program from the control.
Needs no import of the program's graph; runs on the card (`readings`
takes another device, as the tests do). Not part of a run.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from .cell import Cell, load_cell
from .harness import _check, _draw


def _inputs(data: dict, device: torch.device) -> tuple:
    src = torch.from_numpy(data["src"]).to(device)
    dst = torch.from_numpy(data["dst"]).to(device)
    w = None if data["weights"] is None \
        else torch.from_numpy(data["weights"]).to(device)
    return src, dst, w


def control_entries(cell: Cell, data: dict, device="cpu") -> dict:
    """{kind: run(graph, weights, root)} for each job kind whose reference
    has a control: the control on the edge list and weights of `data` (the
    harness's draw for the run's seed), returned as the program's
    VertexArray in original order, for run_cell(entries=...)."""
    from vectorgraphlibrary_tpu_torch.config import TraversalDirection
    from vectorgraphlibrary_tpu_torch.graph.vertices import VertexArray
    src, dst, w = _inputs(data, torch.device(device))

    def entry(kind):
        ref, params = cell.ref(kind), cell.params(kind)

        def run(graph, weights, root):
            vals = ref.solve(src, dst, w, data["v"], root, params,
                             control=True)
            return VertexArray(values=vals,
                               direction=TraversalDirection.ORIGINAL)
        return run
    return {k: entry(k) for k in cell.kinds if cell.ref(k).CONTROL}


def readings(root, workload: str, seed: int, answers: int,
             device="cuda") -> tuple:
    """(checks {name: {"value": worst control reading, "limit": limit}},
    correct) for one seed, as the harness's check judges the control."""
    cell = load_cell(root, workload)
    device = torch.device(device)
    data = _draw(cell, seed, device, lambda msg: None)
    src, dst, w = _inputs(data, device)
    got = {}
    for kind in cell.kinds:
        ref = cell.ref(kind)
        if ref.CONTROL is None:
            continue
        params = cell.params(kind)
        roots = data["roots"][:answers] if cell.job(kind).NEEDS_ROOTS \
            else [None]
        got[kind] = [(r, ref.solve(src, dst, w, data["v"], r, params,
                                   control=True)) for r in roots]
    checks, judged, failed = _check(cell, data, got, device,
                                    lambda msg: None)
    return checks, failed == 0 and judged > 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds, three or more")
    p.add_argument("--answers", type=int, default=4)
    args = p.parse_args(argv)
    root = Path.cwd()
    least, correct = {}, []
    for seed in (int(s) for s in args.seeds.split(",")):
        checks, ok = readings(root, args.workload, seed, args.answers)
        correct.append(ok)
        for name, c in checks.items():
            least[name] = min(least.get(name, c["value"]), c["value"])
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": ok, "control": checks}), flush=True)
    print(json.dumps({"workload": args.workload, "least_control": least,
                      "not_correct_on_every_seed": not any(correct)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
