"""host_reads_per_job.bfs: the port's host reads (vgl.host_read spans of
models/common.read_scalar and read_scalars) that start inside the bfs job
spans of the trace, over those jobs. Moves bfs_gteps. Nothing is read from a
program without the spans."""
from portbench.spans import host_reads_per_job

KIND = "bfs"


def read(run):
    return None if run.trace is None else host_reads_per_job(run.trace, KIND)
