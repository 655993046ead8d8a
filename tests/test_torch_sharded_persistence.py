"""PyTorch port, sharded persistence (graph/persistence.save_sharded_graph,
load_sharded_graph): a sharded graph (RMAT-10, average degree 8, seed 3, 4
shards) saved by the JAX package loads in the port equal to the port's
fresh import, shard by shard, and its one-card PageRank equals the fresh
graph's bit for bit; one saved by the port loads in the JAX package, whose
PageRank on it equals its own fresh graph's; the two packages write the
same files, key by key (but the JAX package's per-slot edge indices), with
the format string "sharded_csr"; device="cpu"
keeps every tensor in host memory."""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorgraphlibrary_tpu.graph import persistence as jpersist
from vectorgraphlibrary_tpu.io import generation as jgen
from vectorgraphlibrary_tpu.parallel import shard_build as jsb
from vectorgraphlibrary_tpu.parallel import sharded as jsh

from vectorgraphlibrary_tpu_torch.graph import persistence
from vectorgraphlibrary_tpu_torch.io import generation
from vectorgraphlibrary_tpu_torch.parallel import sharded
from vectorgraphlibrary_tpu_torch.parallel import shard_build as sb

N_SHARDS = 4
PR_ITERS = 20


def _tensors(obj, prefix=""):
    out = {}
    if isinstance(obj, torch.Tensor):
        out[prefix] = obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            out.update(_tensors(getattr(obj, f.name), f"{prefix}.{f.name}"))
    elif isinstance(obj, (tuple, list)):
        for i, x in enumerate(obj):
            out.update(_tensors(x, f"{prefix}[{i}]"))
    else:
        out[prefix] = obj
    return out


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded")
    ec = generation.rmat(scale=10, avg_degree=8, seed=3)
    jec = jgen.rmat(scale=10, avg_degree=8, seed=3)
    sg = sb.import_sharded(ec, N_SHARDS, device="cpu")
    jsg = jsb.import_sharded(jec, N_SHARDS)
    jprefix, prefix = str(d / "jax"), str(d / "port")
    jpersist.save_sharded_graph(jsg, jprefix)
    persistence.save_sharded_graph(sg, prefix)
    return ec, jec, sg, jsg, jprefix, prefix


def test_port_loads_a_jax_sharded_graph(saved):
    ec, _, sg, _, jprefix, _ = saved
    loaded = persistence.load_sharded_graph(jprefix, device="cpu")
    assert (loaded.n_shards, loaded.v, loaded.v_pad, loaded.e,
            loaded.edges_per_shard) == (sg.n_shards, sg.v, sg.v_pad, sg.e,
                                        sg.edges_per_shard)
    for s in range(N_SHARDS):
        got, want = _tensors(loaded.shard(s)), _tensors(sg.shard(s))
        assert got.keys() == want.keys()
        for k in got:
            if isinstance(got[k], torch.Tensor):
                assert got[k].device.type == "cpu"
                assert torch.equal(got[k], want[k]), (s, k)
            else:
                assert got[k] == want[k], (s, k)
    got = sharded.pagerank_sharded_scan(loaded, ec, PR_ITERS)
    assert torch.equal(got, sharded.pagerank_sharded_scan(sg, ec, PR_ITERS))


def test_jax_loads_a_port_sharded_graph(saved):
    _, jec, _, jsg, _, prefix = saved
    loaded = jpersist.load_sharded_graph(prefix)
    assert loaded.n_shards == N_SHARDS and loaded.v_pad == jsg.v_pad
    got = np.asarray(jsh.pagerank_sharded_scan(loaded, jec, PR_ITERS))
    want = np.asarray(jsh.pagerank_sharded_scan(jsg, jec, PR_ITERS))
    np.testing.assert_array_equal(got, want)


def test_both_packages_write_the_same_files(saved):
    *_, jprefix, prefix = saved
    with open(jprefix + ".meta.json") as f, open(prefix + ".meta.json") as g:
        assert json.load(f) == json.load(g)
    for s in range(N_SHARDS):
        with np.load(f"{jprefix}.shard{s}.npz") as z, \
                np.load(f"{prefix}.shard{s}.npz") as y:
            assert str(z["format"][0]) == str(y["format"][0]) == "sharded_csr"
            # the JAX package also stores per-slot edge indices (eidx) to
            # lay out its tile copies of edge values; the port keeps none
            assert sorted(y.files) == sorted(
                k for k in z.files if not k.endswith(".eidx"))
            for k in y.files:
                assert z[k].dtype == y[k].dtype, k
                np.testing.assert_array_equal(z[k], y[k], err_msg=k)


def test_file_names(saved):
    *_, prefix = saved
    names = sorted(os.listdir(os.path.dirname(prefix)))
    assert [n for n in names if n.startswith("port.")] == [
        "port.meta.json"] + [f"port.shard{s}.npz" for s in range(N_SHARDS)]
