"""CLI parser for the port's apps (the part of
vectorgraphlibrary_tpu/runtime/cli.py that the ported apps use).

Reference flag surface `vgl_runtime/helpers/cmd_parser/cmd_parser.hpp:58-228`:
synthetic graph (-s/-e with -rmat/-ru, -seed), -check, -it, -dev.
"""
from __future__ import annotations

import argparse

from ..config import VGLConfig, SyntheticGraphType


def build_parser(app: str = "vgl") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=app,
                                description=f"VGL (PyTorch/CUDA) {app} benchmark")
    p.add_argument("-s", "-scale", dest="scale", type=int, default=14,
                   help="log2 |V| for synthetic graphs")
    p.add_argument("-e", "-edges", dest="avg_degree", type=int, default=16,
                   help="average degree for synthetic graphs")
    p.add_argument("-rmat", dest="rmat", action="store_true", default=True)
    p.add_argument("-ru", "-random_uniform", dest="ru", action="store_true")
    p.add_argument("-check", dest="check", action="store_true")
    p.add_argument("-it", "-iterations", dest="iterations", type=int, default=10)
    p.add_argument("-dev", "-device", dest="device", default="cuda",
                   help="torch device; 'cuda' (default) needs a card, 'cpu' "
                        "runs the kernels' plain PyTorch versions")
    p.add_argument("-seed", dest="seed", type=int, default=42)
    return p


def parse_args(argv=None, app: str = "vgl") -> VGLConfig:
    ns = build_parser(app).parse_args(argv)
    return VGLConfig(
        scale=ns.scale,
        avg_degree=ns.avg_degree,
        synthetic_type=(SyntheticGraphType.RANDOM_UNIFORM if ns.ru
                        else SyntheticGraphType.RMAT),
        check=ns.check,
        iterations=ns.iterations,
        device=ns.device,
        seed=ns.seed,
    )
