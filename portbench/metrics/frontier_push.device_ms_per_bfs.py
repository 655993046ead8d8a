"""frontier_push.device_ms_per_bfs: device milliseconds per BFS job of the
frontier's compaction sort (graph/frontier.compact_ids, torch.sort's
radix-sort kernels) and of the sparse push kernels (csrc/push_expand.cu,
csrc/scatter_combine.cu), inside the BFS job spans of the trace, over the
BFS jobs traced. Moves bfs_gteps."""
from portbench.trace import device_in_spans

KIND = "bfs"
KERNELS = (r"[Ss]ort|push_expand_kernel"
           r"|scatter_(combine|build_sorted)\w*_kernel")


def read(run):
    if run.trace is None:
        return None
    n = sum(1 for j in run.jobs if j.kind == KIND)
    if not n:
        return None
    us, count = device_in_spans(run.trace, KIND, KERNELS)
    return us / 1e3 / n if count else None
