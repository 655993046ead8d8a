"""import_routes_s: host-clock seconds of the three vertex routes
(ops/route.make_route_plan, the kept vgl.import.vertex_routes span of
graph/device.from_host) inside the process's last graph import (the kept
vgl.import span of graph/device.import_graph), read from the port's kept
spans (runtime/profiling.kept_spans). Moves setup_s. Nothing is read from
a program without kept spans."""
from portbench.spans import import_phase_s

PHASE = "vgl.import.vertex_routes"


def read(run):
    return import_phase_s(PHASE)
