"""PyTorch port, GraphSAGE: the aggregation (sums, counts, means) against
the JAX package and the sequential oracle, its gradient (the same pull over
the transposed CSR) against jax.grad and torch.autograd.gradcheck, the
sampling formula on JAX's own uniforms, and the 2-layer model with
parameters carried across: logits, loss, gradients and three Adam steps
against the JAX package's (optax), and the loss falling as in
tests/test_algorithms3.py. The JAX package runs as tests/conftest.py sets it
up (routed paths, Pallas in interpret mode; its aggregation uses no Pallas).

Tolerances: sums and logits at rtol 1e-5 (another summation order), with an
atol of 1e-6 (gradients) or 1e-5 (logits) times the largest entry, since
entries near zero are differences of large sums; loss, gradients and
parameters after three Adam steps at rtol 1e-4, as the matrix products and
softmax add their own rounding in each package; counts and ids exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import optax

from vectorgraphlibrary_tpu.config import TraversalDirection as JDir
from vectorgraphlibrary_tpu.graph.device import import_graph as jimport_graph
from vectorgraphlibrary_tpu.io import generation as jgeneration
from vectorgraphlibrary_tpu.models import gnn as jgnn

from vectorgraphlibrary_tpu_torch.config import TraversalDirection as TDir
from vectorgraphlibrary_tpu_torch.graph.device import import_graph as timport_graph
from vectorgraphlibrary_tpu_torch.models import gnn as tgnn
from vectorgraphlibrary_tpu_torch.ops.cuda import pull_rows as pr

DIRS = {"G": (JDir.GATHER, TDir.GATHER), "S": (JDir.SCATTER, TDir.SCATTER)}
PARAMS = ("w_self1", "w_nbr1", "b1", "w_self2", "w_nbr2", "b2")


@pytest.fixture(scope="module")
def graphs(request):
    """name -> (ec, JAX graph, port graph): RMAT-10 (hub rows), RU-9 (no
    hubs) and test_algorithms3's RMAT-7 (vertices without neighbours)."""
    cache = {}

    def get(name):
        if name not in cache:
            ec = (jgeneration.rmat(scale=7, avg_degree=4, seed=17)
                  if name == "tiny" else request.getfixturevalue(name))
            cache[name] = (ec, jimport_graph(ec),
                           timport_graph(ec, device="cpu"))
        return cache[name]
    return get


def _close(got, want, rtol, atol_of_max, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=atol_of_max * float(np.abs(want).max()),
        err_msg=err_msg)


@pytest.mark.parametrize("f", [1, 16, 100])
@pytest.mark.parametrize("d", ["G", "S"])
@pytest.mark.parametrize("name", ["small_rmat", "small_ru"])
def test_aggregation_matches_jax(graphs, name, d, f):
    ec, jg, tg = graphs(name)
    jd, td = DIRS[d]
    feats = np.random.default_rng(f).random((jg.v_pad, f)).astype(np.float32)
    js, jc = jgnn.aggregate_sum_count(jg, jnp.asarray(feats), jd)
    ts, tc = tgnn.aggregate_sum_count(tg, torch.from_numpy(feats), td)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-6)
    assert tc.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    tm = tgnn.aggregate_mean(tg, torch.from_numpy(feats), td)
    jm = jgnn.aggregate_mean(jg, jnp.asarray(feats), jd)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5,
                               atol=1e-6)
    if d == "G":
        # against the oracle, in original ids
        s2o = tg.incoming.sorted_to_orig.numpy()[:tg.v]
        o2s = tg.incoming.orig_to_sorted.numpy()[:tg.v]
        want = tgnn.seq_aggregate_mean(ec, feats[:tg.v][np.argsort(s2o)])
        np.testing.assert_allclose(tm.numpy()[:tg.v][o2s], want, rtol=1e-5,
                                   atol=1e-6)


def test_seq_aggregate_mean_matches_jax_oracle(graphs):
    ec, _, _ = graphs("small_rmat")
    feats = np.random.default_rng(2).random((ec.vertices_count, 8))
    np.testing.assert_allclose(tgnn.seq_aggregate_mean(ec, feats),
                               jgnn.seq_aggregate_mean(ec, feats),
                               rtol=1e-12)


@pytest.mark.parametrize("d", ["G", "S"])
@pytest.mark.parametrize("name", ["small_rmat", "tiny"])
def test_aggregation_gradient_matches_jax(graphs, name, d):
    _, jg, tg = graphs(name)
    jd, td = DIRS[d]
    rng = np.random.default_rng(7)
    feats = rng.random((jg.v_pad, 12)).astype(np.float32)
    r = rng.standard_normal((jg.v_pad, 12)).astype(np.float32)
    want = jax.grad(lambda x: jnp.sum(
        jgnn.aggregate_sum_count(jg, x, jd)[0] * r))(jnp.asarray(feats))
    x = torch.from_numpy(feats).requires_grad_()
    before = pr.pull_rows.launches
    (tgnn.aggregate_sum_count(tg, x, td)[0] * torch.from_numpy(r)).sum() \
        .backward()
    assert pr.pull_rows.launches == before      # the CPU runs the plain one
    _close(x.grad.numpy(), want, 1e-5, 1e-6)


@pytest.mark.parametrize("d", ["G", "S"])
def test_aggregation_gradcheck(graphs, d):
    """f64 gradcheck of the sums through the plain version, on RMAT-7."""
    _, _, tg = graphs("tiny")
    x = torch.from_numpy(np.random.default_rng(4).random((tg.v_pad, 3))) \
        .requires_grad_()
    assert torch.autograd.gradcheck(
        lambda t: tgnn.aggregate_sum_count(tg, t, DIRS[d][1])[0], (x,))


def test_row_csr_lists_every_long_row():
    """RowCSR lists exactly the rows of more than HUB_MIN edges from its own
    row_ptr (the kernel leaves an unlisted long row to no one); on the CPU
    pull_rows is the plain version."""
    degs = [0, pr.HUB_MIN, pr.HUB_MIN + 1, 3, 5000, pr.HUB_MIN - 1]
    row_ptr = torch.from_numpy(np.concatenate([[0], np.cumsum(degs)])
                               .astype(np.int32))
    rng = np.random.default_rng(3)
    col_idx = torch.from_numpy(rng.integers(0, 9, int(row_ptr[-1]))
                               .astype(np.int32))
    csr = pr.RowCSR(row_ptr, col_idx)
    assert csr.hubs.dtype == torch.int32 and csr.hubs.tolist() == [2, 4]
    x = torch.from_numpy(rng.integers(-9, 9, (9, 5)).astype(np.float32))
    before = pr.pull_rows.launches
    assert torch.equal(pr.pull_rows(csr, x),
                       pr.pull_rows_ref(row_ptr, col_idx, x))
    assert pr.pull_rows.launches == before


def test_transposed_csr(graphs):
    """Row u of the transpose lists the rows holding u, ascending, each as
    often as it holds u."""
    _, _, tg = graphs("small_rmat")
    dg = tg.incoming
    rp, ci = tgnn.transposed_csr(dg)
    e = dg.e
    rows = np.repeat(np.arange(dg.v_pad), dg.degrees.numpy())
    cols = dg.col_idx.numpy()[:e]
    order = np.lexsort((rows, cols))
    np.testing.assert_array_equal(ci.numpy(), rows[order])
    np.testing.assert_array_equal(
        rp.numpy(), np.concatenate([[0], np.cumsum(
            np.bincount(cols, minlength=dg.v_pad))]))


@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("d", ["G", "S"])
@pytest.mark.parametrize("name", ["small_rmat", "tiny"])
def test_sampling_formula_on_jax_uniforms(graphs, name, d, k):
    _, jg, tg = graphs(name)
    jd, td = DIRS[d]
    key = jax.random.PRNGKey(k)
    u = np.array(jax.random.uniform(key, (jg.v_pad, k)))
    want = jgnn.sample_neighbors(jg, k, key, jd)
    got = tgnn._sample_from_uniforms(tg.direction(td), torch.from_numpy(u))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("d", ["G", "S"])
def test_seeded_sample_properties(graphs, d):
    """Every sampled id is a neighbour; a vertex without neighbours samples
    itself; one seed gives one sample."""
    _, _, tg = graphs("tiny")
    td = DIRS[d][1]
    gen = torch.Generator().manual_seed(5)
    s = tgnn.sample_neighbors(tg, 6, gen, td)
    again = tgnn.sample_neighbors(tg, 6, torch.Generator().manual_seed(5), td)
    assert s.shape == (tg.v_pad, 6) and torch.equal(s, again)
    dg = tg.direction(td)
    rp, ci = dg.row_ptr.numpy(), dg.col_idx.numpy()
    lonely = 0
    for v in range(tg.v_pad):
        nbrs = set(ci[rp[v]:rp[v + 1]].tolist())
        if not nbrs:
            lonely += 1
            assert (s[v] == v).all()
        else:
            assert set(s[v].tolist()) <= nbrs
    assert lonely > 0


def _jax_loss(params, jg, feats, labels, mask, s1, s2):
    """The reference's loss_fn (vectorgraphlibrary_tpu/models/gnn.py:147-152,
    a closure of make_train_step)."""
    logits = jgnn.sage_forward(params, jg, feats, s1, s2)
    logp = jax.nn.log_softmax(logits)
    nll = -jnp.take_along_axis(logp, labels[:, None], axis=1)[:, 0]
    return jnp.sum(jnp.where(mask, nll, 0.0)) / jnp.maximum(jnp.sum(mask), 1)


@pytest.fixture(scope="module")
def sage(graphs):
    """(JAX graph, port graph, JAX params, inputs as numpy, JAX samples) on
    RMAT-10 with in 12, hidden 16, classes 5."""
    _, jg, tg = graphs("small_rmat")
    rng = np.random.default_rng(11)
    feats = rng.random((jg.v_pad, 12)).astype(np.float32)
    labels = rng.integers(0, 5, jg.v_pad).astype(np.int32)
    mask = (np.arange(jg.v_pad) < jg.v) & (rng.random(jg.v_pad) < 0.7)
    params = jgnn.init_sage(jax.random.PRNGKey(2), 12, 16, 5)
    s1 = jgnn.sample_neighbors(jg, 4, jax.random.PRNGKey(3))
    s2 = jgnn.sample_neighbors(jg, 3, jax.random.PRNGKey(4))
    return jg, tg, params, (feats, labels, mask), (s1, s2)


def _port(params):
    return tgnn.sage_params_from_numpy(
        {k: np.asarray(v) for k, v in params._asdict().items()}, device="cpu")


def _samples(sampled, samples):
    if not sampled:
        return (None, None), (None, None)
    return samples, tuple(torch.from_numpy(np.array(s)) for s in samples)


@pytest.mark.parametrize("sampled", [False, True])
def test_sage_forward_matches_jax(sage, sampled):
    jg, tg, params, (feats, _, _), samples = sage
    (j1, j2), (t1, t2) = _samples(sampled, samples)
    want = jgnn.sage_forward(params, jg, jnp.asarray(feats), j1, j2)
    with torch.no_grad():
        got = tgnn.sage_forward(_port(params), tg, torch.from_numpy(feats),
                                t1, t2)
    _close(got.numpy(), want, 1e-5, 1e-5)


@pytest.mark.parametrize("sampled", [False, True])
def test_sage_loss_and_gradients_match_jax(sage, sampled):
    jg, tg, params, (feats, labels, mask), samples = sage
    (j1, j2), (t1, t2) = _samples(sampled, samples)
    loss_j, grads_j = jax.value_and_grad(_jax_loss)(
        params, jg, jnp.asarray(feats), jnp.asarray(labels),
        jnp.asarray(mask), j1, j2)
    p = _port(params)
    loss_t = tgnn.sage_loss(p, tg, torch.from_numpy(feats),
                            torch.from_numpy(labels), torch.from_numpy(mask),
                            t1, t2)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-4)
    # rtol 1e-4 plus 1e-6 of the gradient's largest entry: f32 rounding
    # order alone moves a near-zero entry (1.4e-05 of w_self1, sampled) by
    # up to 7.6e-05 of itself, and by how much depends on the torch thread
    # count; the largest absolute error of any entry is 3e-08
    for k in PARAMS:
        _close(getattr(p, k).grad.numpy(), np.asarray(getattr(grads_j, k)),
               1e-4, 1e-6, err_msg=k)


@pytest.mark.parametrize("sampled", [False, True])
def test_three_adam_steps_match_optax(sage, sampled):
    jg, tg, params, (feats, labels, mask), samples = sage
    (j1, j2), (t1, t2) = _samples(sampled, samples)
    opt = optax.adam(1e-2)
    jstep = jgnn.make_train_step(jg, opt)
    jp, state = params, opt.init(params)
    p = _port(params)
    tstep = tgnn.make_train_step(tg, torch.optim.Adam(p.parameters(),
                                                      lr=1e-2))
    args_t = (torch.from_numpy(feats), torch.from_numpy(labels),
              torch.from_numpy(mask), t1, t2)
    for _ in range(3):
        jp, state, loss_j = jstep(jp, state, jnp.asarray(feats),
                                  jnp.asarray(labels), jnp.asarray(mask),
                                  j1, j2)
        loss_t = tstep(p, *args_t)
        np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-4)
    for k in PARAMS:
        np.testing.assert_allclose(getattr(p, k).detach().numpy(),
                                   np.asarray(getattr(jp, k)), rtol=1e-4,
                                   err_msg=k)


def test_train_step_decreases_loss(graphs):
    """tests/test_algorithms3.py:146-167 on the port: 8 sampled steps of
    Adam on RMAT-7 from seeded inputs."""
    _, _, tg = graphs("tiny")
    gen = torch.Generator().manual_seed(0)
    f, h, c = 8, 16, 3
    feats = torch.randn((tg.v_pad, f), generator=gen)
    labels = torch.randint(0, c, (tg.v_pad,), generator=gen)
    mask = torch.arange(tg.v_pad) < tg.v
    params = tgnn.init_sage(torch.Generator().manual_seed(2), f, h, c)
    step = tgnn.make_train_step(tg, torch.optim.Adam(params.parameters(),
                                                     lr=1e-2))
    s1 = tgnn.sample_neighbors(tg, 4, torch.Generator().manual_seed(3))
    s2 = tgnn.sample_neighbors(tg, 4, torch.Generator().manual_seed(4))
    losses = [float(step(params, feats, labels, mask, s1, s2))
              for _ in range(8)]
    assert losses[-1] < losses[0]
    full = [float(step(params, feats, labels, mask)) for _ in range(8)]
    assert full[-1] < full[0]
