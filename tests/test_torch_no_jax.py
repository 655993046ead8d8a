"""PyTorch port: no module of the port (nor chip_smoke.py) imports jax or the
JAX package, and running the slices on the CPU (PageRank, a DO-BFS root,
SSSP in its all-active and partial forms, SSWP, HITS and CC on a weighted
graph, SCC, coloring, label propagation, random walks, reachability and the
triangle count, GraphSAGE's full and sampled training steps, the general
advance in every graph format, compute and reduce with a frontier,
max-flow and its app's input, saving a graph, which runs the port's own
Beneš router, and loading it, the sharded container with its one-card
drivers (PageRank, HITS, BFS, CC, SSSP, MS-BFS, CC hybrid and SSSP on
hashed weights, on full and slim shards), its sharded save and load
with the weights, the five streamed algorithms, the
per-primitive profiling pass on a scale-10 graph with and without weights,
the PageRank app with that pass, the large tier's builder and apps,
rmat_fast on two forked workers, the scale-24 tier's shard-count rule,
cross-check and bench rows on a small artifact, and the LiveJournal
replica's generator, bench rows and host oracle at a small size)
neither loads the JAX package's native library nor launches a kernel."""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, os, pkgutil, sys, tempfile
import vectorgraphlibrary_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from vectorgraphlibrary_tpu_torch.io import generation
from vectorgraphlibrary_tpu_torch.graph.device import import_graph
from vectorgraphlibrary_tpu_torch.models import pr
from vectorgraphlibrary_tpu_torch.graph import persistence
from vectorgraphlibrary_tpu_torch.models import bfs, cc, hits, sssp, sswp
from vectorgraphlibrary_tpu_torch.models import coloring, lp, rw, scc, tc
from vectorgraphlibrary_tpu_torch.config import VGLConfig
from vectorgraphlibrary_tpu_torch.runtime import runtime
from vectorgraphlibrary_tpu_torch.ops.cuda import and_popcount as ap
from vectorgraphlibrary_tpu_torch.ops.cuda import lane_shuffle as ls
from vectorgraphlibrary_tpu_torch.ops.cuda import pull_reduce as pl
from vectorgraphlibrary_tpu_torch.ops.cuda import push_expand as pe
from vectorgraphlibrary_tpu_torch.ops.cuda import route_gather as rg
from vectorgraphlibrary_tpu_torch.ops.cuda import scatter_combine as sc
g = import_graph(generation.rmat(9, 4, seed=1, weighted=False), device="cpu")
pr.vgl_page_rank(g, max_iterations=2, use_convergence=False)
bfs.vgl_bfs_device(g, 0, id_cap=64, edge_cap=256)
ec, wg, ea = runtime.prepare_graph(VGLConfig(scale=8, avg_degree=4, seed=1),
                                   need_weights=True, device="cpu")
sssp.vgl_dijkstra_all_active(wg, ea, 0)
sssp.vgl_dijkstra_partial_active(wg, ea, 0)
sssp.vgl_dijkstra_partial_device(wg, ea, 0, id_cap=16, edge_cap=128)
sssp.vgl_dijkstra_multi(wg, ea, [0, 1])
sswp.vgl_widest_paths(wg, ea, 0)
hits.vgl_hits(wg, iterations=2)
cc.vgl_shiloach_vishkin(wg)
cc.vgl_cc_hybrid(wg)
cc.vgl_bfs_based(wg)
sssp.seq_dijkstra(ec, 0), sswp.seq_widest_paths(ec, 0), hits.seq_hits(ec, 2)
cc.seq_cc(ec)
scc.vgl_forward_backward(wg), scc.seq_scc(ec)
coloring.vgl_coloring(wg, ec=ec, core_threshold=8), coloring.seq_coloring(ec)
lp.vgl_label_propagation(wg, max_iterations=3)
lp.seq_label_propagation_fast(ec, 3), lp.seq_label_propagation(ec, 3)
rw.vgl_random_walk(wg, [0, 1], walk_length=3, store_walk_paths=True)
rw.seq_random_walk_reachable(ec, 0, 3)
tc.reachability(ec, wg, [0, 1]), tc.vgl_bfs_based_reachability(wg, [0])
tc.seq_reachability(ec, [0])
tc.vgl_triangle_count(ec, block_bits=64, device="cpu"), tc.seq_triangle_count(ec)
import torch
from vectorgraphlibrary_tpu_torch.config import GraphFormat
from vectorgraphlibrary_tpu_torch.graph import frontier
from vectorgraphlibrary_tpu_torch.models import gnn, mf
from vectorgraphlibrary_tpu_torch.ops import advance
from vectorgraphlibrary_tpu_torch.ops.compute import compute
from vectorgraphlibrary_tpu_torch.ops.reduce import reduce as vreduce
from vectorgraphlibrary_tpu_torch.ops.cuda import pull_rows as prw
from vectorgraphlibrary_tpu_torch.apps import mf as mf_app
params = gnn.init_sage(torch.Generator().manual_seed(0), 4, 8, 3)
step = gnn.make_train_step(wg, torch.optim.Adam(params.parameters(), lr=1e-2))
feats = torch.rand(wg.v_pad, 4)
labels = torch.randint(0, 3, (wg.v_pad,))
mask = torch.arange(wg.v_pad) < wg.v
step(params, feats, labels, mask)
s1 = gnn.sample_neighbors(wg, 3, torch.Generator().manual_seed(1))
step(params, feats, labels, mask, s1, s1)
gnn.seq_aggregate_mean(ec, feats[:wg.v].numpy())
for fmt in GraphFormat.TILE_CSR, GraphFormat.CSR, GraphFormat.EDGES_LIST:
    fg = import_graph(ec, graph_format=fmt, device="cpu", keep_edge_slots=True)
    advance.advance_pull(fg, {"x": feats[:, 0]}, lambda s, d, w: s["x"] * d["x"],
                         "add", dst_arrays={"x": feats[:, 1]})
advance.advance_pull_fast(wg, {"x": feats[:, 0]}, lambda s, d, w: s["x"] + w,
                          "min", edge_values=ea.incoming,
                          src_active=feats[:, 2] > 0.5)
advance.advance_pull_routed(wg, feats[:, 0], lambda v, i, d, w: v, "max")
fr = frontier.from_mask(wg, feats[:, 3] > 0.5, frontier.TraversalDirection.SCATTER)
compute(wg, {"x": feats[:, 0]}, lambda i, dg, a: {"x": a["x"] + 1}, frontier=fr)
vreduce(wg, feats[:, 0], "add", frontier=fr)
ec2 = mf_app.prepare(ec, 1)
src = int(ec2.src_ids[0])
mf.vgl_ford_fulkerson(ec2, None, src, mf_app.sink_for(ec2, src), device="cpu")
mf.vgl_mf_bfs_levels(ec2, None, ec2.weights * 0, src, device="cpu")
mf.seq_ford_fulkerson(ec2, src, mf_app.sink_for(ec2, src))
with tempfile.TemporaryDirectory() as d:
    persistence.save_graph_to_binary_file(g, os.path.join(d, "g.npz"))
    g2 = persistence.load_graph_from_binary_file(os.path.join(d, "g.npz"),
                                                 device="cpu")
pr.vgl_page_rank(g2, max_iterations=2, use_convergence=False)
from vectorgraphlibrary_tpu_torch.parallel import shard_build, sharded
hs = []
sg = shard_build.import_sharded(ec, 2, device="cpu", _host_out=hs)
shard_build.estimated_shard_slots(ec, 2)
sharded.pagerank_sharded_scan(sg, ec, 2), sharded.hits_sharded_scan(sg, 2)
sharded.bfs_sharded_scan(sg, 0), sharded.cc_sharded_scan(sg)
sharded.sssp_sharded_scan(sg, shard_build.shard_edge_values(ec.weights, sg,
                                                            ec, hs), 0)
with tempfile.TemporaryDirectory() as d:
    persistence.save_sharded_graph(sg, os.path.join(d, "s"))
    sg2 = persistence.load_sharded_graph(os.path.join(d, "s"), device="cpu")
sharded.pagerank_sharded_scan(sg2, ec, 2)
from vectorgraphlibrary_tpu_torch.parallel import streaming
slim = shard_build.import_sharded(ec, 2, device="cpu", slim=True)
sharded.msbfs_sharded_scan(slim, list(range(32)))
sharded.cc_hybrid_sharded_scan(slim, 0)
sharded.sssp_sharded_scan_hash(slim, 0)
with tempfile.TemporaryDirectory() as d:
    persistence.save_sharded_graph(slim, os.path.join(d, "s"))
    persistence.save_sharded_weights(sharded.route_slot_weights(
        sg, shard_build.shard_edge_values(ec.weights, sg, ec, hs)),
        os.path.join(d, "s"))
    ssg = streaming.load_streamed(os.path.join(d, "s"), weights=True,
                                  device="cpu")
rev, dmask = sharded.pr_consts(ec)
streaming.pagerank_streamed(ssg, rev, dmask, 2)
streaming.hits_streamed(ssg, 2), streaming.msbfs_streamed(ssg, range(32))
streaming.cc_hybrid_streamed(ssg, 0), streaming.sssp_streamed(ssg, 0)
from vectorgraphlibrary_tpu_torch.runtime import prim_profile
from vectorgraphlibrary_tpu_torch.runtime.perf_stats import PerformanceStats
from vectorgraphlibrary_tpu_torch.apps import pr as pr_app
from vectorgraphlibrary_tpu_torch.apps.app_common import run_app
pg = import_graph(generation.rmat(10, 8, seed=2, weighted=False), device="cpu")
prim_profile.profile_graph_primitives(pg, None, stats=PerformanceStats())
prim_profile.profile_graph_primitives(wg, ea, stats=PerformanceStats())
assert run_app("pr", pr_app.run_round, pr_app.check_round, needs_source=False,
               argv=["-s", "10", "-e", "8", "-it", "1", "-check", "-dev",
                     "cpu"]) == 0
from vectorgraphlibrary_tpu_torch.apps import (bench_s22w_resident,
                                               bench_scale25, build_scale25)
from vectorgraphlibrary_tpu_torch.io.generation import rmat_fast
rmat_fast(8, 4, seed=1, chunk=256, workers=2)
from vectorgraphlibrary_tpu_torch.apps import (bench_scale24, build_scale24,
                                               crosscheck_scale20)
ec24 = generation.rmat(9, 4, seed=42, weighted=False)
assert build_scale24.shard_count(ec24) == 2
assert crosscheck_scale20.crosscheck(ec24, 2, "cpu")["ok"]
with tempfile.TemporaryDirectory() as d:
    persistence.save_sharded_graph(shard_build.import_sharded(
        ec24, 2, device="cpu", slim=True), os.path.join(d, "s"))
    rev, dmask = sharded.pr_consts(ec24)
    import numpy as np
    np.savez(os.path.join(d, "s.prconsts.npz"), rev=rev, dmask=dmask)
    bench_scale24.run(os.path.join(d, "s"), "cpu")
from vectorgraphlibrary_tpu_torch.apps import bench_lj, make_lj_replica
assert bench_lj.run(make_lj_replica.replica(700, 6000, 60), "cpu",
                    check_rows=True)[-1]["ok"]
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "jaxlib" or m.startswith("jaxlib.")
       or m == "vectorgraphlibrary_tpu" or m.startswith("vectorgraphlibrary_tpu.")]
maps = open("/proc/self/maps").read() if sys.platform == "linux" else ""
print("MODULES", len(names))
print("BAD", bad)
print("NATIVE", "libvgl_native" in maps)
print("ROUTER", "libvgl_router" in maps)
print("LAUNCHES", rg.route_gather_finish.launches + ls.lane_shuffle.launches
      + pl.pull_reduce.launches + pe.push_expand.launches
      + sc.scatter_combine.launches + ap.and_popcount.launches
      + pl.segment_reduce.launches + prw.pull_rows.launches)
"""


def test_port_never_imports_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = dict(ln.split(" ", 1) for ln in out.stdout.splitlines()
                 if ln.split(" ", 1)[0] in ("MODULES", "BAD", "NATIVE",
                                            "ROUTER", "LAUNCHES"))
    assert int(lines["MODULES"]) >= 60
    assert lines["BAD"] == "[]"
    assert lines["NATIVE"] == "False"
    assert lines["ROUTER"] == "True"          # the port's own router ran
    assert lines["LAUNCHES"] == "0"
