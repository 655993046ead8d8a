"""import_s: host-clock seconds of the port's graph import in set-up
(graph/device.import_graph without the advance route and, where the mix
needs weights, graph/edges.build_edge_array_from_host), ended by a
synchronize. Moves setup_s."""


def read(run):
    return run.setup.get("import_s")
