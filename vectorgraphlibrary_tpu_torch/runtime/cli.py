"""CLI parser for the port's apps (the part of
vectorgraphlibrary_tpu/runtime/cli.py that the ported apps use).

Reference flag surface `vgl_runtime/helpers/cmd_parser/cmd_parser.hpp:58-228`:
graph source (-load a binary .el_container, -import a KONECT text file, or a
synthetic graph: -gen, the default, with -s/-e, -rmat/-ru and -seed), -check,
-it, -dev, the variant flags -td/-bu/-do (BFS), -sv/-bfs-based (CC) and
-purdoms/-bfs-based (TC) (cfg.algorithm_variant), SSSP's
-all-active/-partial-active and -push/-pull (cfg.all_active,
cfg.push_mode), -format (el, csr, csr_vg, vect_csr: cfg.graph_format; only
vect_csr builds the advance route, and every format runs the same CSR
kernels here; auto: vect_csr with cfg.autotune_format, and
runtime.prepare_graph lets utils/autotuner pick) and -no-prim-stats
(cfg.prim_stats).
"""
from __future__ import annotations

import argparse

from ..config import GraphFormat, VGLConfig, SyntheticGraphType


def build_parser(app: str = "vgl") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=app,
                                description=f"VGL (PyTorch/CUDA) {app} benchmark")
    p.add_argument("-load", dest="load_path", default=None,
                   help="load binary .el_container graph")
    p.add_argument("-import", dest="import_path", default=None,
                   help="import KONECT text graph")
    p.add_argument("-gen", dest="gen", action="store_true",
                   help="generate synthetic graph (default)")
    p.add_argument("-s", "-scale", dest="scale", type=int, default=14,
                   help="log2 |V| for synthetic graphs")
    p.add_argument("-e", "-edges", dest="avg_degree", type=int, default=16,
                   help="average degree for synthetic graphs")
    p.add_argument("-rmat", dest="rmat", action="store_true", default=True)
    p.add_argument("-ru", "-random_uniform", dest="ru", action="store_true")
    p.add_argument("-format", dest="graph_format", default="vect_csr",
                   help="el, csr, csr_vg or vect_csr (the default); only "
                        "vect_csr builds the advance route, and every format "
                        "runs the same CSR kernels. auto: vect_csr, with the "
                        "huge-row tile parameters and the format picked by "
                        "utils/autotuner from samples measured on a TPU")
    p.add_argument("-check", dest="check", action="store_true")
    p.add_argument("-it", "-iterations", dest="iterations", type=int, default=10)
    p.add_argument("-push", dest="push", action="store_true",
                   help="all-active SSSP/SSWP: accepted as in the reference "
                        "CLI, and selects the same pull kernel as -pull "
                        "(each sweep relaxes every edge either way). "
                        "-partial-active is the push from a compacted "
                        "frontier")
    p.add_argument("-pull", dest="pull", action="store_true")
    p.add_argument("-all-active", dest="all_active", action="store_true")
    p.add_argument("-partial-active", dest="partial_active", action="store_true")
    p.add_argument("-td", dest="variant_td", action="store_true")
    p.add_argument("-bu", dest="variant_bu", action="store_true")
    p.add_argument("-do", dest="variant_do", action="store_true")
    p.add_argument("-sv", dest="variant_sv", action="store_true")
    p.add_argument("-bfs-based", dest="variant_bfs_based", action="store_true")
    p.add_argument("-purdoms", dest="variant_purdoms", action="store_true")
    p.add_argument("-dev", "-device", dest="device", default="cuda",
                   help="torch device; 'cuda' (default) needs a card, 'cpu' "
                        "runs the kernels' plain PyTorch versions")
    p.add_argument("-seed", dest="seed", type=int, default=42)
    p.add_argument("-no-prim-stats", dest="prim_stats", action="store_false",
                   help="skip the per-primitive profiling pass after the "
                        "run: accepted as in the reference CLI; it does "
                        "nothing until that pass is ported")
    return p


def parse_args(argv=None, app: str = "vgl") -> VGLConfig:
    ns = build_parser(app).parse_args(argv)
    variant = "auto"
    for name in ("td", "bu", "do", "sv", "bfs_based", "purdoms"):
        if getattr(ns, f"variant_{name}"):
            variant = name
    autotune = ns.graph_format.lower() == "auto"
    return VGLConfig(
        scale=ns.scale,
        avg_degree=ns.avg_degree,
        synthetic_type=(SyntheticGraphType.RANDOM_UNIFORM if ns.ru
                        else SyntheticGraphType.RMAT),
        graph_format=(GraphFormat.TILE_CSR if autotune
                      else GraphFormat.parse(ns.graph_format)),
        autotune_format=autotune,
        load_path=ns.load_path,
        import_path=ns.import_path,
        check=ns.check,
        iterations=ns.iterations,
        push_mode=not ns.pull,
        all_active=not ns.partial_active,
        algorithm_variant=variant,
        device=ns.device,
        seed=ns.seed,
        prim_stats=ns.prim_stats,
    )
