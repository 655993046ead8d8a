"""PyTorch port on the card: the route-gather kernel against its plain version
(bit for bit), its launch count, its argument checks, and the slice on CUDA
against the slice on the CPU. Every test here needs an NVIDIA GPU and skips
without one. The file needs no JAX (the card's host has none), so on the card
run it without tests/conftest.py, which imports jax:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorgraphlibrary_tpu_torch.graph.device import import_graph
from vectorgraphlibrary_tpu_torch.io import generation
from vectorgraphlibrary_tpu_torch.models import pr
from vectorgraphlibrary_tpu_torch.ops.cuda import route_gather as rg

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["f32", "i32", "i8"])
@pytest.mark.parametrize("wop", [None, "add", "min", "max", "mul"])
def test_kernel_equals_plain_version(cuda, dtype, wop):
    rng = np.random.default_rng(1)
    n = 1 << 16
    idx = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(cuda)
    flags = torch.from_numpy(rng.integers(0, 4, n).astype(np.uint8)).to(cuda)

    def data():
        if dtype == "f32":
            return rng.standard_normal(n).astype(np.float32)
        if dtype == "i32":
            return rng.integers(-2**31, 2**31 - 1, n,
                                dtype=np.int64).astype(np.int32)
        return rng.integers(-128, 128, n).astype(np.int8)
    x = torch.from_numpy(data()).to(cuda)
    w = None if wop is None else torch.from_numpy(data()).to(cuda)
    for kw in ({}, dict(flags=flags, exclude_self_loops=True, ident=-3),
               dict(flags=flags, exclude_self_loops=False, ident=5)):
        if wop is not None:
            kw = dict(kw, weight_op=wop, weights=w)
        before = rg.route_gather_finish.launches
        got = rg.route_gather_finish(x, idx, **kw)
        torch.cuda.synchronize()
        assert rg.route_gather_finish.launches == before + 1
        want = rg.route_gather_finish_ref(x, idx, **kw)
        if dtype == "f32":
            got, want = got.view(torch.int32), want.view(torch.int32)
        assert torch.equal(got, want)


def test_kernel_rejects_what_it_does_not_take(cuda):
    idx = torch.arange(8, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        rg.route_gather_finish(torch.zeros(8, dtype=torch.float64,
                                           device=cuda), idx)
    with pytest.raises(TypeError):
        rg.route_gather_finish(torch.zeros(8, device=cuda), idx.long())
    with pytest.raises(ValueError):
        rg.route_gather_finish(torch.zeros(8, device=cuda), idx,
                               flags=torch.zeros(8, dtype=torch.uint8))


def test_page_rank_on_cuda_matches_cpu(cuda):
    iters = 20
    ec = generation.rmat(10, 8, seed=3, weighted=False)
    cpu = pr.vgl_page_rank(import_graph(ec, device="cpu"),
                           max_iterations=iters, use_convergence=False)[0]
    g = import_graph(ec, device=cuda)
    rg.route_gather_finish.launches = 0
    ranks = pr.vgl_page_rank(g, max_iterations=iters, use_convergence=False)[0]
    torch.cuda.synchronize()
    assert rg.route_gather_finish.launches == 1 + 2 * iters
    np.testing.assert_allclose(ranks.values.cpu().numpy(),
                               cpu.values.numpy(), rtol=1e-5, atol=1e-8)
