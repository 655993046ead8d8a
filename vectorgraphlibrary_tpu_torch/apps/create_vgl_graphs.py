"""Graph preparation utility (port of apps/create_vgl_graphs.py; reference
apps/utilites/create_vgl_graphs.cpp:7-45): generate or convert (KONECT text)
a graph, save it as a binary .el_container and, with -preprocess, import it
with the port and save the preprocessed device graph (.npz) in the format
both packages read (graph/persistence.py).

    python -m vectorgraphlibrary_tpu_torch.apps.create_vgl_graphs \\
        -gen rmat -s 18 -e 32 -file g.el_container -preprocess g.npz

`-dev` (default cuda) is the device the graph is imported on before it is
saved; `-dev cpu` needs no card.
"""
from __future__ import annotations

import argparse
import sys
import time

from ..graph.device import import_graph
from ..graph.persistence import save_graph_to_binary_file
from ..io import generation
from ..io.konect import import_konect


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="create_vgl_graphs")
    p.add_argument("-gen", choices=["rmat", "ru"], default=None)
    p.add_argument("-s", type=int, default=14)
    p.add_argument("-e", type=int, default=16)
    p.add_argument("-convert", default=None, help="KONECT text file to convert")
    p.add_argument("-undirected", action="store_true")
    p.add_argument("-file", required=True, help="output .el_container path")
    p.add_argument("-preprocess", default=None,
                   help="also build + save the preprocessed device graph (.npz)")
    p.add_argument("-dev", "-device", dest="device", default="cuda",
                   help="torch device the graph is imported on")
    a = p.parse_args(argv)
    if a.convert:
        ec = import_konect(a.convert, directed=not a.undirected)
    else:
        ec = generation.generate(a.gen or "rmat", a.s, a.e)
    ec.save_to_binary_file(a.file)
    print(f"saved |V|={ec.vertices_count} |E|={ec.edges_count} -> {a.file}")
    if a.preprocess:
        t0 = time.perf_counter()
        g = import_graph(ec, device=a.device)
        t1 = time.perf_counter()
        save_graph_to_binary_file(g, a.preprocess)
        print(f"preprocessed graph -> {a.preprocess} (import {t1 - t0:.2f} s, "
              f"save {time.perf_counter() - t1:.2f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
