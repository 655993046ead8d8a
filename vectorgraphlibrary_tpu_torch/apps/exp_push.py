"""What does a BFS or-scatter cost at sparse-push sizes on the card, and what
does one hand-written kernel give against the plain PyTorch scatter?
(port of apps/exp_push.py; CUDA only, raises without a card)

    python -m vectorgraphlibrary_tpu_torch.apps.exp_push

Into an int32 array of V = 2^20 vertices, from ecap = 2^15, 2^16 and 2^17
random destinations, REP = 8 scatters (destinations shifted by the round
number, so a few fall past V and are dropped), each variant timed by CUDA
events, ms per scatter:
  a) the plain version: scatter_reduce amax of message 1;
  b) sort the destinations, then the same scatter;
  c) the scatter_combine kernel with op="or", message 1 (the reference's
     Pallas kernel, apps/exp_push.py make_c/_kern).
Prints one JSON line.
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..ops.cuda.scatter_combine import scatter_combine, scatter_combine_ref

V = 1 << 20
REP = 8
LOG_ECAPS = (15, 16, 17)


def _ms_per_scatter(fn, dsts: torch.Tensor, out: torch.Tensor) -> float:
    """Mean device ms of one scatter over REP shifted rounds (CUDA events),
    after one untimed pass."""
    def rounds():
        o = out
        for i in range(REP):
            o = fn(o, dsts + i)
        return o
    rounds()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    rounds()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REP


VARIANTS = {
    "a_scatter": lambda o, d: scatter_combine_ref(o, d, 1, "max"),
    "b_sorted": lambda o, d: scatter_combine_ref(o, torch.sort(d).values, 1,
                                                 "max"),
    "c_kernel": lambda o, d: scatter_combine(o, d, 1, "or"),
}


def measure(device="cuda", seed: int = 0) -> dict:
    """{"<variant>_2^<lg>_ms": ms per scatter} for every variant and ecap."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("exp_push measures the card: it needs a CUDA device")
    rng = np.random.default_rng(seed)
    res = {}
    for lg in LOG_ECAPS:
        dsts = torch.from_numpy(
            rng.integers(0, V, 1 << lg).astype(np.int32)).to(device)
        out0 = torch.zeros(V, dtype=torch.int32, device=device)
        for name, fn in VARIANTS.items():
            res[f"{name}_2^{lg}_ms"] = _ms_per_scatter(fn, dsts, out0)
    return res


def main() -> int:
    res = measure()
    for k, ms in res.items():
        print(f"{k}: {ms:.4f}", flush=True)
    print(json.dumps(dict(res, device=torch.cuda.get_device_name(0))),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
