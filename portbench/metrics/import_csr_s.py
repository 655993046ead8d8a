"""import_csr_s: host-clock seconds of the two host CSR builds
(graph/build.build_directed_csr, the kept vgl.import.csr spans) inside the
process's last graph import (the kept vgl.import span of
graph/device.import_graph), read from the port's kept spans
(runtime/profiling.kept_spans). Moves setup_s. Nothing is read from a
program without kept spans."""
from portbench.spans import import_phase_s

PHASE = "vgl.import.csr"


def read(run):
    return import_phase_s(PHASE)
