"""device_idle_pct.<mix>: the device's idle share of the traced window, in
%: 100 x (1 - the time in which some kernel, copy or set ran on the card /
the window), from the trace. One reader for every mix's name
(`device_idle_pct.sweep` moves pagerank_mteps, `device_idle_pct.traverse`
moves sssp_mteps)."""
from portbench.trace import idle_pct


def read(run):
    return None if run.trace is None else idle_pct(run.trace)
