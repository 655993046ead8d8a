"""host_read_idle_pct.<mix>: the share of the traced window, in %, in
which the device sat idle in gaps that a host read of the port opened: a
gap counts when some vgl.host_read span (models/common.read_scalar,
read_scalars) ends after the launch of the device operation before the gap
and no later than the launch of the one after it, all on the host's clock
(spans.host_read_idle_pct). One reader for every mix's name
(`host_read_idle_pct.sweep` moves cc_mteps, `host_read_idle_pct.traverse`
moves sssp_mteps). Nothing is read from a program without the spans."""
from portbench.spans import host_read_idle_pct


def read(run):
    return None if run.trace is None else host_read_idle_pct(run.trace)
