"""PyTorch port, io/generation.rmat_fast against the JAX package's, array for
array: src, dst and weights equal at scales 8 to 11 with chunks of 2^10 to
2^12 edges (several chunks each), on 1 and 2 fork workers, with and without
weights. Chunk ci draws from SeedSequence([seed, ci]) whichever worker runs
it, so the worker count does not change the graph."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorgraphlibrary_tpu.io import generation as jgeneration

from vectorgraphlibrary_tpu_torch.io import generation as tgeneration

# (scale, avg_degree, log2 chunk)
CASES = [(8, 16, 10), (9, 16, 11), (10, 16, 12), (11, 8, 12)]


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("scale,degree,log_chunk", CASES)
def test_rmat_fast_equals_jax(scale, degree, log_chunk, workers, weighted):
    kw = dict(scale=scale, avg_degree=degree, seed=7, weighted=weighted,
              chunk=1 << log_chunk, workers=workers)
    assert (1 << scale) * degree > 2 * kw["chunk"]      # several chunks
    got = tgeneration.rmat_fast(**kw)
    want = jgeneration.rmat_fast(**kw)
    assert got.vertices_count == want.vertices_count == 1 << scale
    for name in ("src_ids", "dst_ids"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    if weighted:
        assert got.weights.dtype == np.float32
        np.testing.assert_array_equal(got.weights, want.weights)
    else:
        assert got.weights is None and want.weights is None
