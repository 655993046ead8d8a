"""levels_per_job.cc: the rounds a flood-hybrid CC job runs, counted by
the port's spans (vectorgraphlibrary_tpu_torch/models/cc.py): vgl.cc.flood
(a flood level), vgl.cc.hook (a hook iteration) and vgl.cc.link (a link
round of _link_rounds) that start inside the cc job spans of the trace,
over those jobs. Each round is a host read and an undirected pull over
every row. A program without link rounds reads its floods and hooks
alone; nothing is read from a program without the spans. Moves
cc_mteps."""
import numpy as np

KIND = "cc"
NAMES = ("vgl.cc.flood", "vgl.cc.hook", "vgl.cc.link")


def read(run):
    if run.trace is None:
        return None
    jobs = np.array([(s, e) for k, s, e in run.trace.spans if k == KIND],
                    dtype=float).reshape(-1, 2)
    starts = np.sort(np.array([h[1] for h in run.trace.host
                               if h[0] in NAMES], dtype=float))
    if not len(jobs) or not len(starts):
        return None
    inside = (np.searchsorted(starts, jobs[:, 1], side="right")
              - np.searchsorted(starts, jobs[:, 0], side="left"))
    return float(inside.sum()) / len(jobs)
