"""Real-graph corpus: local cache and load (port of the local tier of
vectorgraphlibrary_tpu/io/corpus.py).

Capability match for the reference harness's corpus machinery
(`apps/scripts/create_graphs_api.py:83-206`, `settings.py:52-86`): named
KONECT graphs are converted once to the binary .el_container format and
served from a local cache. The cache directory ($VGL_GRAPH_DIR, else
<repo>/.graphs/) and its files are the JAX package's, so a conversion made
by either package serves both. Any KONECT-format file (or prepared
.el_container) placed under it is picked up by name, and
`any_cached_graph()` uses whatever is present.

The port never downloads: `download` returns None, as the JAX package's
does when it cannot reach the network. The two real graphs shipped in the
repository are read by path from the JAX package's data directory
(BUNDLED_DIR); they are data files, and nothing of that package is
imported.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

from .edges_container import EdgesContainer
from .konect import import_konect

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# KONECT internal names (http://konect.cc/networks/): the reference's corpus
# categories — soc / web / road / rating (create_graphs_api.py:83-206)
KONECT_GRAPHS = {
    "soc-livejournal": "soc-LiveJournal1",
    "soc-pokec": "soc-pokec-relationships",
    "soc-orkut": "orkut-links",
    "soc-youtube": "youtube-u-growth",
    "web-baidu": "zhishi-baidu-internallink",
    "web-wiki-en": "wikipedia_link_en",
    "web-trackers": "trackers-trackers",
    "road-texas": "roadNet-TX",
    "road-california": "roadNet-CA",
    "rating-amazon": "amazon-ratings",
    "rating-netflix": "netflix",
}

# real-world graphs shipped in the repository, largest first (software
# call and dependency networks, a KONECT category): pycalls, a static
# function-call graph (~495k functions, ~1.51M call edges); pydeps, a module
# import network (~31.6k modules, ~222k import edges)
BUNDLED = ["pycalls", "pydeps"]
BUNDLED_DIR = os.path.join(_REPO, "vectorgraphlibrary_tpu", "data")


def graph_dir() -> str:
    d = os.environ.get("VGL_GRAPH_DIR") or os.path.join(_REPO, ".graphs")
    os.makedirs(d, exist_ok=True)
    return d


def _container_path(name: str) -> str:
    return os.path.join(graph_dir(), f"{name}.el_container")


def _find_text_file(name: str) -> Optional[str]:
    """A KONECT text file for `name` anywhere under the cache dir."""
    internal = KONECT_GRAPHS.get(name, name)
    for root, _, files in os.walk(graph_dir()):
        for f in files:
            if f.startswith(("out.", "out_")) and internal in root:
                return os.path.join(root, f)
            if f in (f"{name}.txt", f"{name}.el", f"{internal}.txt"):
                return os.path.join(root, f)
    return None


def download(name: str, timeout: float = 60.0) -> Optional[str]:
    """The port does not fetch graphs: always None, with where to put the
    file instead."""
    del timeout
    print(f"corpus: {name} is not cached and is not downloaded; place its "
          f"KONECT file under {graph_dir()} to use it")
    return None


def load(name: str, fetch: bool = True) -> Optional[EdgesContainer]:
    """Cached container → cached text (converted once) → None. fetch=True
    also asks `download`, which finds nothing."""
    cpath = _container_path(name)
    if os.path.exists(cpath):
        return EdgesContainer.load_from_binary_file(cpath)
    txt = _find_text_file(name)
    if txt is None and fetch:
        download(name)
    if txt is None:
        return None
    ec = import_konect(txt)
    ec.save_to_binary_file(cpath)           # convert once (reference -convert)
    return ec


def bundled_graph(name: Optional[str] = None
                  ) -> Tuple[str, Optional[EdgesContainer]]:
    """A real-world graph shipped in the repository, converted once to
    .el_container in the cache. Default: the largest bundled graph."""
    for cand in ([name] if name else BUNDLED):
        cpath = _container_path(cand)
        if os.path.exists(cpath):
            return cand, EdgesContainer.load_from_binary_file(cpath)
        src = os.path.join(BUNDLED_DIR, f"{cand}.el.gz")
        if os.path.exists(src):
            ec = import_konect(src)
            ec.save_to_binary_file(cpath)
            return cand, ec
    return (name or "pydeps"), None


def any_cached_graph() -> Tuple[Optional[str], Optional[EdgesContainer]]:
    """(name, EdgesContainer) of some locally available corpus graph, or the
    bundled real graph as last resort. Prefers prepared .el_container
    files."""
    d = graph_dir()
    for f in sorted(os.listdir(d)):
        if f.endswith(".el_container"):
            name = f[:-len(".el_container")]
            return name, EdgesContainer.load_from_binary_file(
                os.path.join(d, f))
    for name in KONECT_GRAPHS:
        ec = load(name, fetch=False)
        if ec is not None:
            return name, ec
    return bundled_graph()
