"""Graph export (copied from vectorgraphlibrary_tpu/io/export.py, numpy
only): GraphViz .dot (reference
`vgl_runtime/visualization/graphviz/graphviz_export.h`, small graphs only,
threshold `settings.h:135`), Ligra text format (reference
`vgl_runtime/export_graphs/ligra_export.h:15-30`) and a plain edge list.
The files are byte for byte the JAX package's."""
from __future__ import annotations

import numpy as np

from .edges_container import EdgesContainer

VISUALISATION_SMALL_GRAPH_VERTEX_THRESHOLD = 30


def save_to_graphviz_file(ec: EdgesContainer, path: str,
                          labels: np.ndarray = None,
                          force: bool = False) -> bool:
    """Writes a .dot digraph; refuses large graphs like the reference unless
    forced. Returns True if written."""
    if ec.vertices_count > VISUALISATION_SMALL_GRAPH_VERTEX_THRESHOLD and not force:
        return False
    with open(path, "w") as f:
        f.write("digraph G {\n")
        if labels is not None:
            for vtx in range(ec.vertices_count):
                f.write(f'  {vtx} [label="{vtx}:{labels[vtx]}"];\n')
        for s, d in zip(ec.src_ids.tolist(), ec.dst_ids.tolist()):
            f.write(f"  {s} -> {d};\n")
        f.write("}\n")
    return True


def export_to_ligra_text_unweighted(ec: EdgesContainer, path: str) -> None:
    """AdjacencyGraph text format: header, |V|, |E|, offsets, edges."""
    v, e = ec.vertices_count, ec.edges_count
    order = np.argsort(ec.src_ids, kind="stable")
    dst = ec.dst_ids[order]
    offsets = np.concatenate(
        [[0], np.cumsum(np.bincount(ec.src_ids, minlength=v))])[:-1]
    with open(path, "w") as f:
        f.write("AdjacencyGraph\n")
        f.write(f"{v}\n{e}\n")
        np.savetxt(f, offsets, fmt="%d")
        np.savetxt(f, dst, fmt="%d")


def export_to_edges_list(ec: EdgesContainer, path: str,
                         weighted: bool = False) -> None:
    cols = [ec.src_ids, ec.dst_ids]
    if weighted and ec.weights is not None:
        cols.append(ec.weights)
    np.savetxt(path, np.column_stack(cols),
               fmt="%d %d %.6f" if len(cols) == 3 else "%d %d")
