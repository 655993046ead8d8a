"""The generators repeat per seed and keep their distributions' sizes."""
import torch

from portbench.cell import load_module
from conftest import REPO

GEN = REPO / "portbench" / "gen"
KRON = {"scale": 12, "edge_factor": 16, "a": 0.57, "b": 0.19, "c": 0.19}
CL = {"vertices": 3001, "edges": 42600, "gamma": 2.65, "max_degree": 200}


def _draw(name, params, seed):
    return load_module(GEN / f"{name}.py").edges(params, seed, "cpu")


def test_kronecker_repeats_per_seed_and_keeps_its_sizes():
    src, dst, v = _draw("kronecker", KRON, 2**31 + 5)
    again = _draw("kronecker", KRON, 2**31 + 5)
    other = _draw("kronecker", KRON, 2**31 + 6)
    assert v == 4096
    assert src.dtype == dst.dtype == torch.int32
    assert src.numel() == dst.numel() == 16 * 4096
    assert int(src.min()) >= 0 and int(src.max()) < v
    assert int(dst.min()) >= 0 and int(dst.max()) < v
    assert torch.equal(src, again[0]) and torch.equal(dst, again[1])
    assert not torch.equal(src, other[0])


def test_kronecker_symmetrised_holds_each_tuple_both_ways():
    """With `symmetrise` the list is the directed draw's tuples, then the
    same tuples reversed: every arc has its reverse, degrees in equal out."""
    src, dst, v = _draw("kronecker", KRON, 2**31 + 5)
    s2, d2, v2 = _draw("kronecker", dict(KRON, symmetrise=True), 2**31 + 5)
    e = src.numel()
    assert v2 == v and s2.numel() == d2.numel() == 2 * e
    assert torch.equal(s2[:e], src) and torch.equal(d2[:e], dst)
    assert torch.equal(s2[e:], dst) and torch.equal(d2[e:], src)
    assert torch.equal(torch.bincount(s2.long(), minlength=v),
                       torch.bincount(d2.long(), minlength=v))


def test_kronecker_quadrant_shares():
    """Top bits follow a + b (source bit clear) and a + c (destination bit
    clear), about 0.76 each."""
    src, dst, v = _draw("kronecker", KRON, 7)
    top = v // 2
    assert abs(float((src < top).float().mean()) - 0.76) < 0.01
    assert abs(float((dst < top).float().mean()) - 0.76) < 0.01


def test_chung_lu_repeats_per_seed_and_keeps_its_sizes():
    src, dst, v = _draw("chung_lu", CL, 12345678901)
    again = _draw("chung_lu", CL, 12345678901)
    assert v == 3001 and src.numel() == dst.numel() == 42600
    assert int(src.max()) < v and int(dst.max()) < v
    assert int(src.min()) >= 0 and int(dst.min()) >= 0
    assert torch.equal(src, again[0]) and torch.equal(dst, again[1])
    assert not torch.equal(src, dst)


def test_chung_lu_degrees_follow_the_expected_weights():
    """Vertex 0 holds the largest expected degree, capped at max_degree;
    low ranks get more edges than high ranks."""
    src, _, v = _draw("chung_lu", CL, 3)
    deg = torch.bincount(src.long(), minlength=v).double()
    assert 0.7 * 200 < float(deg[0]) < 1.3 * 200
    assert float(deg[:30].mean()) > 5 * float(deg[-1000:].mean())


def test_a_seed_relabels_one_graph(tiny_root):
    """Every seed runs the configuration's one graph, relabelled and its
    edges reordered: the same seed repeats, another gives an isomorphic
    graph (the same degree multisets, the same weights)."""
    from portbench.cell import load_cell
    from portbench.harness import _draw

    def draw(seed):
        return _draw(load_cell(tiny_root, "tiny-cl.traverse"), seed,
                     torch.device("cpu"), lambda msg: None)

    a, b, c = draw(2**31 + 1), draw(2**31 + 1), draw(2**31 + 2)
    for key in ("src", "dst", "weights"):
        assert (a[key] == b[key]).all()
    assert a["roots"] == b["roots"] and a["roots"] != c["roots"]
    assert not (a["src"] == c["src"]).all()

    def degrees(d):
        return sorted(torch.bincount(torch.from_numpy(d["src"]).long(),
                                     minlength=d["v"]).tolist())
    assert degrees(a) == degrees(c)
    assert sorted(a["weights"].tolist()) == sorted(c["weights"].tolist())
    deg = torch.bincount(torch.from_numpy(c["src"]).long(), minlength=c["v"])
    assert all(int(deg[r]) > 0 for r in c["roots"])
