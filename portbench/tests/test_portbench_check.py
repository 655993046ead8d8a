"""The check: the plain reference against the port on the CPU, the control
(the reference in bfloat16) failing the harness's check, alone and in the
program's place in a whole run, and the timed path broken underneath a
whole run making `correct` false.

The faults a cell of this benchmark can have: a job that returns its state
unchanged, half of its answer left out, one answer altered where it is
produced. The cells take one chip: no exchange between chips to leave
out."""
import pytest
import torch

from portbench.cell import load_cell
from portbench.control import control_entries, readings
from portbench.harness import _draw, run_cell

QUIET = {"log": lambda msg: None}
CELLS = ("tiny-kron.sweep", "tiny-kron.traverse", "tiny-cl.sweep",
         "tiny-cl.traverse")


@pytest.mark.parametrize("cell", CELLS)
def test_the_port_agrees_with_the_plain_reference(tiny_root, cell):
    r = run_cell(tiny_root, cell, 3 * 2**31 + 1, 0.3, False, "cpu", **QUIET)
    assert r["correct"], r["checks"]
    for name, c in r["checks"].items():
        assert c["value"] <= c["limit"], name


CONTROLLED = [("tiny-kron.sweep", "pagerank_rel_err"),
              ("tiny-cl.sweep", "pagerank_rel_err"),
              ("tiny-kron.traverse", "sssp_rel_err"),
              ("tiny-cl.traverse", "sssp_rel_err")]


@pytest.mark.parametrize("cell,check", CONTROLLED)
def test_the_control_fails_its_limit(tiny_root, cell, check):
    """control.readings scores the control by the harness's own check."""
    for seed in (1, 2, 3):
        checks, correct = readings(tiny_root, cell, seed, 2, "cpu")
        assert not correct, (seed, checks)
        assert checks[check]["value"] > 3 * checks[check]["limit"], \
            (seed, checks)


@pytest.mark.parametrize("cell,check", CONTROLLED)
def test_the_control_in_the_programs_place_is_not_correct(tiny_root, cell,
                                                          check):
    """A whole run with the control as the timed path's job: `correct`
    comes out false, and the check that fails is the one it was set for."""
    seed = 2**31 + 77
    c = load_cell(tiny_root, cell)
    data = _draw(c, seed, torch.device("cpu"), lambda msg: None)
    r = run_cell(tiny_root, cell, seed, 0.2, False, "cpu",
                 entries=control_entries(c, data), **QUIET)
    assert not r["correct"] and r["failed"] > 0, r["checks"]
    assert r["checks"][check]["value"] > r["checks"][check]["limit"]


def _initial(kind, v_pad, root, dtype):
    """A job's state before its first step, in original order."""
    if kind == "pagerank":
        return torch.full((v_pad,), 1.0, dtype=dtype) / v_pad
    if kind == "cc":
        return torch.arange(v_pad, dtype=dtype)
    if kind == "bfs":
        out = torch.full((v_pad,), -1, dtype=dtype)
    else:
        out = torch.full((v_pad,), float("inf"), dtype=dtype)
    out[root] = 1 if kind == "bfs" else 0
    return out


def _broken(real, kind, fault):
    from vectorgraphlibrary_tpu_torch.config import TraversalDirection
    from vectorgraphlibrary_tpu_torch.graph.vertices import (VertexArray,
                                                             reorder)

    def run(graph, weights, root):
        vals = reorder(real(graph, weights, root), graph,
                       TraversalDirection.ORIGINAL).values.clone()
        init = _initial(kind, vals.shape[0], root, vals.dtype)
        v = graph.v
        if fault == "unchanged":
            vals = init
        elif fault == "half":
            vals[v // 2:] = init[v // 2:]
        else:
            # one answer altered: the last vertex the job reached
            j = int(torch.nonzero(vals[:v] != init[:v]).flatten()[-1]) \
                if kind != "pagerank" else v - 1
            if kind == "cc":
                vals[j] = v + 7
            elif kind == "bfs":
                vals[j] += 1
            else:
                vals[j] *= 1.01
        return VertexArray(values=vals, direction=TraversalDirection.ORIGINAL)
    return run


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", ["tiny-kron.sweep", "tiny-kron.traverse"])
def test_a_broken_timed_path_is_not_correct(tiny_root, cell, fault):
    c = load_cell(tiny_root, cell)
    for kind in c.kinds:
        real = c.job(kind).entry(c.params(kind))
        r = run_cell(tiny_root, cell, 9, 0.2, False, "cpu",
                     entries={kind: _broken(real, kind, fault)}, **QUIET)
        assert not r["correct"], (kind, fault, r["checks"])
        assert r["failed"] > 0
