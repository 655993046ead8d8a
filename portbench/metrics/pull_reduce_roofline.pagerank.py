"""pull_reduce_roofline.pagerank: the PageRank jobs' advance pulls
(ops/advance.advance_pull_value -> csrc/pull_reduce.cu) as a share of
their bytes bound, in %.

Bytes: per pull, roofline.pull_bytes over the graph's real |V| and |E|
(f32 x and output, no weights), times the pulls the program counted on
pull_reduce.launches inside the PageRank jobs. Time: the device time of
pull_reduce_kernel and pull_reduce_fixup_kernel inside the PageRank job
spans of the trace. Nothing is read when the window ran no PageRank job,
when the jobs launched segment_reduce (its kernels share the names), or
when the trace holds another count of pull_reduce_kernel than the program
launched (the profiler dropped events). Moves pagerank_mteps."""
from portbench import roofline
from portbench.trace import device_in_spans

KIND = "pagerank"


def read(run):
    if run.trace is None:
        return None
    jobs = [j for j in run.jobs if j.kind == KIND and j.counters is not None]
    pulls = sum(j.counters.get("pull_reduce", 0) for j in jobs)
    if not pulls or any(j.counters.get("segment_reduce") for j in jobs):
        return None
    us, _ = device_in_spans(run.trace, KIND,
                            r"pull_reduce_(fixup_)?kernel")
    _, tiles = device_in_spans(run.trace, KIND, r"pull_reduce_kernel")
    if tiles != pulls or us <= 0:
        return None
    nbytes = pulls * roofline.pull_bytes(run.v, run.e)
    return roofline.share_pct(nbytes, us / 1e6, run.device_kind)
