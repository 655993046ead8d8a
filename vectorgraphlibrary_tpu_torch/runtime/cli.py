"""CLI parser for the port's apps (the part of
vectorgraphlibrary_tpu/runtime/cli.py that the ported apps use).

Reference flag surface `vgl_runtime/helpers/cmd_parser/cmd_parser.hpp:58-228`:
graph source (-load a binary .el_container, -import a KONECT text file, or a
synthetic graph: -s/-e with -rmat/-ru, -seed), -check, -it, -dev, the
variant flags -td/-bu/-do (BFS) and -sv/-bfs-based (CC)
(cfg.algorithm_variant), and SSSP's -all-active/-partial-active and
-push/-pull (cfg.all_active, cfg.push_mode).
"""
from __future__ import annotations

import argparse

from ..config import VGLConfig, SyntheticGraphType


def build_parser(app: str = "vgl") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=app,
                                description=f"VGL (PyTorch/CUDA) {app} benchmark")
    p.add_argument("-load", dest="load_path", default=None,
                   help="load binary .el_container graph")
    p.add_argument("-import", dest="import_path", default=None,
                   help="import KONECT text graph")
    p.add_argument("-s", "-scale", dest="scale", type=int, default=14,
                   help="log2 |V| for synthetic graphs")
    p.add_argument("-e", "-edges", dest="avg_degree", type=int, default=16,
                   help="average degree for synthetic graphs")
    p.add_argument("-rmat", dest="rmat", action="store_true", default=True)
    p.add_argument("-ru", "-random_uniform", dest="ru", action="store_true")
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
    p.add_argument("-dev", "-device", dest="device", default="cuda",
                   help="torch device; 'cuda' (default) needs a card, 'cpu' "
                        "runs the kernels' plain PyTorch versions")
    p.add_argument("-seed", dest="seed", type=int, default=42)
    return p


def parse_args(argv=None, app: str = "vgl") -> VGLConfig:
    ns = build_parser(app).parse_args(argv)
    variant = "auto"
    for name in ("td", "bu", "do", "sv", "bfs_based"):
        if getattr(ns, f"variant_{name}"):
            variant = name
    return VGLConfig(
        scale=ns.scale,
        avg_degree=ns.avg_degree,
        synthetic_type=(SyntheticGraphType.RANDOM_UNIFORM if ns.ru
                        else SyntheticGraphType.RMAT),
        load_path=ns.load_path,
        import_path=ns.import_path,
        check=ns.check,
        iterations=ns.iterations,
        push_mode=not ns.pull,
        all_active=not ns.partial_active,
        algorithm_variant=variant,
        device=ns.device,
        seed=ns.seed,
    )
