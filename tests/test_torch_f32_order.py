"""PyTorch port, the one f32 min/max rule (csrc/f32_minmax.cuh, its plain
side ops/cuda/f32_order.py): the plain versions of the three kernels that
take an f32 min or max — the vertex route's weight join
(route_gather_finish_ref), the pull (pull_reduce_ref, with and without
weights) and the scatter (scatter_combine_ref, Monoid.scatter_at) — against
the JAX package on inputs full of NaN, -0.0 and +0.0, bit for bit (the
int32 views compared). The JAX package runs as its tests run it on the CPU:
its route kernels in Pallas interpret mode (tests/conftest.py). One NaN
value (numpy's) is used throughout: of two NaNs with other bits XLA's
choice is unspecified, and so is the rule's tie-break against it. No
subnormal either: XLA on the CPU flushes them to zero, the card does not."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from vectorgraphlibrary_tpu.config import TraversalDirection as JDir
from vectorgraphlibrary_tpu.graph.device import import_graph as jimport_graph
from vectorgraphlibrary_tpu.graph.edges import (
    build_edge_array_from_host as jbuild_edge_array)
from vectorgraphlibrary_tpu.io import generation as jgeneration
from vectorgraphlibrary_tpu.ops import advance as jadvance
from vectorgraphlibrary_tpu.ops import monoid as jmonoid
from vectorgraphlibrary_tpu.ops.pallas import route_fused
from vectorgraphlibrary_tpu.ops.route import make_route_plan as jmake_route_plan

from vectorgraphlibrary_tpu_torch.config import TraversalDirection as TDir
from vectorgraphlibrary_tpu_torch.graph.device import import_graph as timport_graph
from vectorgraphlibrary_tpu_torch.graph.edges import (
    build_edge_array_from_host as tbuild_edge_array)
from vectorgraphlibrary_tpu_torch.ops import monoid as tmonoid
from vectorgraphlibrary_tpu_torch.ops.cuda import f32_order
from vectorgraphlibrary_tpu_torch.ops.cuda import pull_reduce as pr_mod
from vectorgraphlibrary_tpu_torch.ops.cuda import scatter_combine as sc
from vectorgraphlibrary_tpu_torch.ops.route import (FinishSpec, apply_route,
                                                    make_route_plan)

SPECIAL = np.array([np.nan, -0.0, 0.0, 1.0, -1.0, np.inf, -np.inf, 2.5],
                   np.float32)
_JOP = {"min": jnp.minimum, "max": jnp.maximum}


def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.astype(np.float32).view(np.int32)


def _specials(rng, n, nan_share=0.05) -> np.ndarray:
    """Mostly signed zeros, some numbers, a share of NaN."""
    x = rng.choice(np.array([-0.0, 0.0, 1.0, -1.0, 3.0], np.float32), n,
                   p=[0.35, 0.35, 0.1, 0.1, 0.1]).astype(np.float32)
    x[rng.random(n) < nan_share] = np.nan
    return x


@pytest.mark.parametrize("op", ["min", "max"])
def test_elementwise_rule_equals_jax(op):
    a, b = (g.ravel() for g in np.meshgrid(SPECIAL, SPECIAL))
    want = _JOP[op](a, b)
    fn = f32_order.minimum if op == "min" else f32_order.maximum
    got = fn(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # the keys order every value and invert exactly
    k = f32_order.keys(torch.from_numpy(SPECIAL), op)
    np.testing.assert_array_equal(_bits(f32_order.values(k, op)),
                                  _bits(SPECIAL))


@pytest.mark.parametrize("op", ["min", "max"])
def test_segment_reduce_in_any_order(op):
    """A reduction by the rule gives the same bits in any order of its
    operands (what lets the kernels reduce in tiles and by atomics)."""
    rng = np.random.default_rng(3)
    lengths = rng.integers(0, 6, 200)
    data = _specials(rng, int(lengths.sum()), 0.1)
    ident = np.inf if op == "min" else -np.inf
    got = f32_order.segment_reduce(torch.from_numpy(data),
                                   torch.from_numpy(lengths), op, ident)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    red = jnp.min if op == "min" else jnp.max
    for perm_seed in range(2):
        want = [red(jnp.asarray(np.random.default_rng(perm_seed).permutation(
                    data[s:s + n]))) if n else ident
                for s, n in zip(starts, lengths)]
        np.testing.assert_array_equal(_bits(got), _bits(np.array(
            want, np.float32)))


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("op", ["min", "max"])
def test_route_finish_matches_jax(op, inverse):
    n = 1 << 10
    rng = np.random.default_rng(21)
    perm = rng.permutation(n)
    flags = [rng.integers(0, 4, n).astype(np.uint8) for _ in range(2)]
    x, w = _specials(rng, n), _specials(rng, n)
    jplan = jmake_route_plan(perm, flags_fwd=flags[0], flags_inv=flags[1])
    tplan = make_route_plan(perm, flags_fwd=flags[0], flags_inv=flags[1],
                            device="cpu")
    want = route_fused.apply_route_fused(
        jplan, jnp.asarray(x), inverse=inverse,
        finish=route_fused.FinishSpec(ident=-7.0, exclude_self_loops=False,
                                      weight_op=op),
        weights=jnp.asarray(w))
    got = apply_route(tplan, torch.from_numpy(x), inverse=inverse,
                      finish=FinishSpec(ident=-7.0, exclude_self_loops=False,
                                        weight_op=op),
                      weights=torch.from_numpy(w))
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.fixture(scope="module")
def graphs():
    """(JAX graph, port graph, JAX weights, port weights) of RMAT-9 with
    weights of the same specials."""
    ec = jgeneration.rmat(scale=9, avg_degree=8, seed=13, weighted=False)
    w = _specials(np.random.default_rng(8), ec.edges_count)
    jhost, thost = [], []
    jg = jimport_graph(ec, _host_out=jhost, keep_edge_slots=True)
    tg = timport_graph(ec, device="cpu", _host_out=thost)
    return (jg, tg, jbuild_edge_array(w, jg, jhost[0], jhost[1]),
            tbuild_edge_array(w, tg, thost[0], thost[1]))


# (direction, combine, weight_op)
PULLS = {
    "G-min": ("G", "min", None), "S-max": ("S", "max", None),
    "G-min-of-max": ("G", "min", "max"), "G-max-of-min": ("G", "max", "min"),
    "S-min-of-min": ("S", "min", "min"), "S-max-of-max": ("S", "max", "max"),
}


def _pull_ref(tg, tea, td, x, combine, wop):
    dg = tg.direction(td)
    return dg, pr_mod.pull_reduce_ref(
        dg.row_ptr, dg.col_idx, torch.from_numpy(x), combine,
        weights=None if wop is None else tea.direction(td).flat,
        weight_op=wop)


@pytest.mark.parametrize("case", list(PULLS))
def test_pull_matches_jax(graphs, case):
    """NaN and signed zeros in the weights, against the JAX package's
    fused pull. Its sources hold neither: the fused pull spreads them to
    their slots by a product with a 0/1 matrix, which turns -0.0 into +0.0
    and spreads NaN (test_pull_nan_sources_match_jax_segments holds those
    to JAX's segment reductions)."""
    d, combine, wop = PULLS[case]
    jg, tg, jea, tea = graphs
    jd, td = {"G": (JDir.GATHER, TDir.GATHER),
              "S": (JDir.SCATTER, TDir.SCATTER)}[d]
    x = np.abs(_specials(np.random.default_rng(4), jg.v_pad, nan_share=0.0))
    want = jadvance.advance_pull_value(
        jg, jnp.asarray(x), combine,
        edge_values=None if wop is None else jea.direction(jd),
        weight_op=wop, direction=jd)
    dg, got = _pull_ref(tg, tea, td, x, combine, wop)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # the segment entry's plain version reduces by the same rule
    if wop is None:
        msgs = torch.from_numpy(x)[dg.col_idx[:int(dg.row_ptr[-1])].long()]
        np.testing.assert_array_equal(
            _bits(pr_mod.segment_reduce_ref(dg.row_ptr, msgs, combine)),
            _bits(got))


@pytest.mark.parametrize("case", list(PULLS))
def test_pull_nan_sources_match_jax_segments(graphs, case):
    """NaN and signed zeros in the sources (and the weights), against
    JAX's segment min/max of each row's messages. The JAX package's fused
    pull is no reference for such sources: it spreads them to their slots
    by a product with a 0/1 matrix (vectorgraphlibrary_tpu/ops/tiles.py
    broadcast_rows_flat), so one NaN source turns every row of its 128-lane
    group to NaN (NaN * 0 is NaN), rows that hold no NaN message among them,
    and -0.0 arrives as +0.0 (-0.0 + 0.0 is +0.0)."""
    d, combine, wop = PULLS[case]
    _, tg, _, tea = graphs
    td = {"G": TDir.GATHER, "S": TDir.SCATTER}[d]
    x = _specials(np.random.default_rng(5), tg.v_pad, nan_share=0.02)
    dg, got = _pull_ref(tg, tea, td, x, combine, wop)
    row_ptr = dg.row_ptr.numpy()
    e = int(row_ptr[-1])
    msgs = jnp.asarray(x)[dg.col_idx.numpy()[:e]]
    if wop is not None:
        msgs = _JOP[wop](msgs, jnp.asarray(tea.direction(td).flat.numpy()[:e]))
    rows = np.repeat(np.arange(tg.v_pad), np.diff(row_ptr))
    seg = {"min": jax.ops.segment_min, "max": jax.ops.segment_max}[combine]
    want = seg(msgs, jnp.asarray(rows), num_segments=tg.v_pad)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("const", [False, True], ids=["tensor", "constant"])
@pytest.mark.parametrize("op", ["min", "max"])
def test_scatter_matches_jax(op, const):
    rng = np.random.default_rng(30)
    target = _specials(rng, 64, 0.1)
    idx = rng.integers(-4, 68, 400).astype(np.int32)
    msg = (np.float32(rng.choice([np.nan, -0.0, 0.0]))
           if const else _specials(rng, 400, 0.03))
    vals = np.full(400, msg, np.float32) if const else msg
    want = jmonoid.get(op).scatter_at(jnp.asarray(target), jnp.asarray(idx),
                                      jnp.asarray(vals), mode="drop")
    got = sc.scatter_combine_ref(torch.from_numpy(target),
                                 torch.from_numpy(idx),
                                 float(msg) if const else
                                 torch.from_numpy(msg), op)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    got = tmonoid.get(op).scatter_at(torch.from_numpy(target),
                                     torch.from_numpy(idx),
                                     torch.from_numpy(vals))
    np.testing.assert_array_equal(_bits(got), _bits(want))
