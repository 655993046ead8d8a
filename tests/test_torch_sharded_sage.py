"""PyTorch port, the sharded GraphSAGE (make_sage_loss_sharded,
make_sage_train_step_sharded) on 1, 2 and 4 gloo ranks on the CPU
(tests/torch_rank_cases.sage_rank; ranks import no JAX), each rank
building only its own shard of RMAT-10 (average degree 8, seed 3), with
in 4, hidden 8 and 3 classes. The loss equals the JAX package's
make_sage_loss_sharded on 2 devices of its virtual mesh within rtol 1e-4; the
gradients equal the port's unsharded models/gnn.sage_loss gradients and
JAX's value_and_grad of its sharded loss within rtol 1e-4 and atol 1e-6 of
each gradient's largest entry, on every rank (no rank count scales them);
three Adam steps lower the loss (tests/test_sharded2.py:198-216)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from vectorgraphlibrary_tpu.io import generation as jgen
from vectorgraphlibrary_tpu.models import gnn as jgnn
from vectorgraphlibrary_tpu.parallel import shard_build as jsb
from vectorgraphlibrary_tpu.parallel import sharded as jsh
from vectorgraphlibrary_tpu.parallel.mesh import make_mesh as jmake_mesh

from vectorgraphlibrary_tpu_torch.graph.device import import_graph
from vectorgraphlibrary_tpu_torch.io import generation
from vectorgraphlibrary_tpu_torch.models import gnn
from vectorgraphlibrary_tpu_torch.ops.route import apply_route
from vectorgraphlibrary_tpu_torch.parallel.launch import run_ranks

from tests.torch_rank_cases import sage_inputs

GRAPH = dict(scale=10, degree=8, seed=3)
FDIM, HIDDEN, CLASSES, STEPS = 4, 8, 3, 3
PARAMS = ("w_self1", "w_nbr1", "b1", "w_self2", "w_nbr2", "b2")


def _close(got, want, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-6 * float(np.abs(want).max()),
                               err_msg=err_msg)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    ec = jgen.rmat(scale=10, avg_degree=8, seed=3, weighted=True)
    jsg = jsb.import_sharded(ec, 2)
    params = jgnn.init_sage(jax.random.key(0), FDIM, HIDDEN, CLASSES)
    arrays = {k: np.asarray(v) for k, v in params._asdict().items()}
    path = str(tmp_path_factory.mktemp("sage") / "params.npz")
    np.savez(path, **arrays)
    feats, labels, mask = sage_inputs(jsg.v_pad, jsg.v, FDIM, CLASSES)
    loss_fn = jsh.make_sage_loss_sharded(jsg, jmake_mesh(2, 1,
                                                         jax.devices()[:2]))
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        params, jnp.asarray(feats), jnp.asarray(labels), jnp.asarray(mask))
    # the port's unsharded loss, the inputs in its GATHER ordering
    pec = generation.rmat(scale=10, avg_degree=8, seed=3, weighted=True)
    g = import_graph(pec, device="cpu")
    plan = g.vertex_route_g_from_o
    p = gnn.sage_params_from_numpy(arrays, device="cpu")
    plain = gnn.sage_loss(
        p, g, torch.from_numpy(feats)[plan.fwd_idx.long()],
        apply_route(plan, torch.from_numpy(labels)),
        apply_route(plan, torch.from_numpy(mask)))
    plain.backward()
    return dict(path=path, loss=float(loss),
                grads={k: np.asarray(getattr(grads, k)) for k in PARAMS},
                plain_loss=float(plain.detach()),
                plain_grads={k: getattr(p, k).grad.numpy() for k in PARAMS})


@pytest.fixture(scope="module", params=[1, 2, 4])
def ranks(request, ref):
    return run_ranks("tests.torch_rank_cases:sage_rank", request.param,
                     device="cpu", timeout=300, kwargs=dict(
                         params=ref["path"], fdim=FDIM, classes=CLASSES,
                         steps=STEPS, **GRAPH))


def test_loss_equals_jax(ref, ranks):
    np.testing.assert_allclose(ref["plain_loss"], ref["loss"], rtol=1e-4)
    for r in ranks:
        np.testing.assert_allclose(float(r["loss"]), ref["loss"], rtol=1e-4)


@pytest.mark.parametrize("want", ["plain_grads", "grads"])
def test_gradients_equal_the_unsharded_and_jax(ref, ranks, want):
    for r in ranks:
        for k in PARAMS:
            _close(r[f"grad_{k}"], ref[want][k], err_msg=k)


def test_adam_steps_lower_the_loss(ranks):
    for r in ranks:
        losses = r["losses"]
        assert np.isfinite(losses).all()
        assert losses[-1] < losses[0]
        np.testing.assert_array_equal(losses, ranks[0]["losses"])
