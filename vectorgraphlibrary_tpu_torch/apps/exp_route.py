"""The route kernel (csrc/route_gather.cu) on the card against its first
design and against other cache policies (CUDA only, raises without a card).

    python -m vectorgraphlibrary_tpu_torch.apps.exp_route [-s 18] [--big 20]

At the paths' shapes, on the inverse vertex route s_from_g of RMAT-s
(average degree 32) and of RMAT-big (average degree 16), seed 42, with the
out-degrees as x (int32) and, on RMAT-big, a seeded byte vector (int8, as
DO-BFS's bottom-up levels route bytes), and with PageRank's finish (flags,
self-loops masked; f32) on RMAT-s's advance route and on a random 2^24
route:

  a) device ms per call by torch.profiler (the route kernels' durations,
     the mean of `reps` calls) of: the port's kernel through its wrapper;
     the first design (apps/exp_route_v1.cu, one slot per thread), in
     turns: first, tree, tree, first (on the vertex routes also after the
     flush of b), between launches); a one-call `out.copy_(idx)` of the
     same n (one pass, no dependent read: the floor of a launch at that
     size); torch.index_select; the bytes bound (idx and x read once, out
     written once, at the H100's 3.35 TB/s);
  b) the same kernel source with another cache policy (idx, flags and
     weights under L2's evict_normal; x under evict_first, through L1 or
     past it), without the warp's transpose (each lane gathers its own V
     consecutive slots), with the transposed order but no shared tile
     (4-byte or 1-byte accesses a lane), and with a bulk prefetch of each
     block's share of x into L2: variants of the tree's source text, built
     here (the shipped kernel has no switch), each timed back to back (idx
     and x stay in L2) and after a 96 MB copy that flushes L2 between
     launches, as a pull over a large CSR does on the paths.

Prints the card's name and power limit, then one JSON line. chip_smoke.py
takes `first_design` from here.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from vectorgraphlibrary_tpu_torch.ops.cuda import build
from vectorgraphlibrary_tpu_torch.ops.cuda import route_gather as rg

HBM_BYTES_PER_S = 3.35e12       # H100 SXM (NVIDIA data sheet)
SEED = 42
_APPS = Path(__file__).resolve().parent
_TREE_SOURCE = build._CSRC / "route_gather.cu"

_LOAD_X = "  return __ldg(p);\n"


def _x_hinted(l1: str) -> list:
    """x read under L2's evict_first policy, allocating in L1 (l1 = "") or
    not (l1 = ".L1::no_allocate")."""
    q = f"ld.global.nc{l1}.L2::cache_hint"
    return [(_LOAD_X,
             "  uint64_t pol;\n"
             '  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"'
             ' : "=l"(pol));\n'
             "  if constexpr (sizeof(T) == 1) {\n    int32_t v;\n"
             f'    asm("{q}.s8 %0, [%1], %2;" : "=r"(v) : "l"(p), "l"(pol));'
             "\n    return v;\n  } else {\n    uint32_t v;\n"
             f'    asm("{q}.b32 %0, [%1], %2;" : "=r"(v) : "l"(p), "l"(pol));'
             "\n    return from_bits<T>(v);\n  }\n")]


def _between(text: str, start: str, end: str) -> str:
    a = text.index(start)
    return text[a:text.index(end, a)]


def _scalar_strided(text: str) -> list:
    """No shared tile: each lane reads its indices and writes its outputs
    in the transposed order itself, 4 B (or 1 B) a lane a warp
    instruction."""
    staging = _between(text, "    if (lane < items) {\n      uint32_t j[V];",
                       "    // all of the lane's reads")
    store = _between(text, "    __syncwarp();\n    if (lane < items)\n",
                     "  }\n  const int64_t tail")
    return [(staging, ""), (store, ""),
            ("jj[k] = s < valid ? (int32_t)ti[s] : 0;",
             "jj[k] = s < valid ? (int32_t)ld_b32(idx + tile + s, pol_route)"
             " : 0;"),
            ("        to[s] = v;\n", "        out[tile + s] = v;\n")]


# a bulk prefetch of the block's share of x into L2 (m == n on the exp's
# routes)
_PREFETCH = (
    "  const uint64_t pol_route = policy_route(keep_route);\n",
    "  const uint64_t pol_route = policy_route(keep_route);\n"
    "  if (threadIdx.x == 0) {\n"
    "    const int64_t b0 = (int64_t)blockIdx.x * kThreads * 16;\n"
    "    const int64_t nb = n * (int64_t)sizeof(T);\n"
    "    if (b0 < nb) {\n"
    "      const uint32_t sz = (uint32_t)(nb - b0 < kThreads * 16\n"
    "                                     ? nb - b0 : kThreads * 16)\n"
    "                          & ~15u;\n"
    "      if (sz) asm volatile(\"cp.async.bulk.prefetch.L2.global "
    "[%0], %1;\"\n"
    "                           :: \"l\"((const char*)x + b0), \"r\"(sz)"
    " : \"memory\");\n"
    "    }\n"
    "  }\n")

# (label, [(old, new), ...] or a function of the source text giving them)
_KEEP = "  const int keep_route = route_bytes <= kKeepBytes;\n"
VARIANTS = (
    ("tree", []),
    ("route_always_kept", [(_KEEP, "  const int keep_route = 1;\n")]),
    ("route_always_streamed", [(_KEEP, "  const int keep_route = 0;\n")]),
    ("route_policy_normal", [("L2::evict_last.b64", "L2::evict_normal.b64"),
                             ("L2::evict_first.b64",
                              "L2::evict_normal.b64")]),
    ("x_l1_evict_first", _x_hinted("")),
    ("x_noalloc_evict_first", _x_hinted(".L1::no_allocate")),
    ("no_transpose", [("32 * k + lane", "lane * V + k")]),
    ("scalar_strided", _scalar_strided),
    ("prefetch_x", [_PREFETCH]),
)


class RouteLibrary:
    """The route entries of one built library (`suffix` in the entries'
    names), called as the wrapper calls them: out allocated here, launched
    on the current stream, the CUDA error code checked."""

    def __init__(self, path: Path, suffix: str = ""):
        self.lib = ctypes.CDLL(str(path))
        P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        self.bits = {}
        for size, name in ((4, "b4"), (1, "b1")):
            fn = getattr(self.lib, f"vgl_route_gather{suffix}_{name}")
            fn.argtypes = (P, P, P, LL, P)
            self.bits[size] = fn
        self.f32 = getattr(self.lib, f"vgl_route_gather{suffix}_f32")
        self.f32.argtypes = (P, P, P, P, P, LL, I, I, ctypes.c_float, P)

    @staticmethod
    def _check(rc: int) -> None:
        if rc != 0:
            raise RuntimeError(f"route kernel launch failed: CUDA error {rc}")

    def route(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        out = x.new_empty(idx.shape[0])
        self._check(self.bits[x.element_size()](
            x.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0],
            torch.cuda.current_stream().cuda_stream))
        return out

    def finish_f32(self, x, idx, flags, exclude_self_loops: bool,
                   ident: float) -> torch.Tensor:
        out = x.new_empty(idx.shape[0])
        self._check(self.f32(
            x.data_ptr(), idx.data_ptr(), flags.data_ptr(), None,
            out.data_ptr(), idx.shape[0], int(exclude_self_loops), 0,
            float(ident), torch.cuda.current_stream().cuda_stream))
        return out


def _built(stem: str, source: Path, report: bool = False) -> Path:
    """`source` built into the cache; report: print ptxas' register and
    spill lines."""
    path, log, _ = build.compile_shared(stem, [source], build._nvcc(),
                                        build.NVCC_FLAGS)
    if report and log:
        print(f"  {stem}: " + " | ".join(
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln))
    return path


def first_design(report: bool = False) -> RouteLibrary:
    """The first design of the kernel (apps/exp_route_v1.cu), built at the
    first call into the kernels' build cache."""
    return RouteLibrary(_built("libvgl_route_v1", _APPS / "exp_route_v1.cu",
                               report), "_v1")


def variant(label: str, subs) -> RouteLibrary:
    """The tree's route_gather.cu with each (old, new) of `subs` (or of
    subs(text)) replaced (each must occur), built into the cache."""
    text = _TREE_SOURCE.read_text()
    if callable(subs):
        subs = subs(text)
    for old, new in subs:
        if old not in text:
            raise ValueError(f"variant {label}: {old!r} not in the source")
        text = text.replace(old, new)
    src = build._BUILD_DIR / f"exp_route_{label}.cu"
    build._BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(text)
    return RouteLibrary(_built(f"libvgl_route_{label}", src, report=True))


def device_ms(fn, reps: int = 20, name: str = "", between=None):
    """Device time of one call: the durations of the kernels whose name
    holds `name`, by torch.profiler over `reps` calls, divided by reps.
    between(), when given, runs before each call (its kernels do not count
    unless their names hold `name`). None where the profiler recorded
    none of those kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if between is not None:
                between()
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == DeviceType.CUDA and name in e.name]
    if not dev:
        return None         # the profiler recorded none of them
    return sum(e.time_range.elapsed_us() for e in dev) / reps / 1e3


def bound_ms(n: int, x_bytes: int, finish_kept: int = -1) -> float:
    """idx and x read once and out written once; with a finish, the flags
    read and only the kept slots' x read and out... written (as PRs 1-11
    counted the 2^24 route: idx and flags per slot, 8 B per kept slot)."""
    if finish_kept >= 0:
        return (n * (4 + 1) + finish_kept * (4 + 4)) / HBM_BYTES_PER_S * 1e3
    return n * (4 + 2 * x_bytes) / HBM_BYTES_PER_S * 1e3


def _vertex_cases(scale: int, degree: int, dev, with_bytes: bool,
                  finish_cases: list) -> list:
    """The graph's inverse vertex route on int32 x (and on bytes); where
    finish_cases is given, its advance route with PageRank's finish is
    appended there."""
    from vectorgraphlibrary_tpu_torch.graph.device import import_graph
    from vectorgraphlibrary_tpu_torch.io import generation
    ec = generation.rmat(scale=scale, avg_degree=degree, seed=SEED)
    g = import_graph(ec, device=dev, build_route=finish_cases is not None)
    if finish_cases is not None:
        plan = g.advance_route
        finish_cases.append((f"rmat{scale}_advance_f32_finish",
                             torch.rand(plan.n, device=dev), plan.fwd_idx,
                             plan.flags_fwd))
    vplan = g.vertex_route_s_from_g
    cases = [(f"rmat{scale}_vertex_i32_inv", g.outgoing.degrees,
              vplan.inv_idx)]
    if with_bytes:
        rng = np.random.default_rng(SEED)
        xb = torch.from_numpy(rng.integers(0, 2, vplan.n).astype(
            np.int8)).to(dev)
        cases.append((f"rmat{scale}_vertex_i8_inv", xb, vplan.inv_idx))
    return cases


def _assert_equal(label: str, got, want) -> None:
    torch.cuda.synchronize()
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    if not torch.equal(got, want):
        raise AssertionError(f"{label}: the kernel differs from its plain "
                             "version")


def measure(scale: int = 18, big: int = 20, reps: int = 20) -> dict:
    dev = torch.device("cuda")
    v1 = first_design(report=True)
    res = {}
    finish_cases = []
    cases = (_vertex_cases(scale, 32, dev, False, finish_cases)
             + _vertex_cases(big, 16, dev, True, None))
    rng = np.random.default_rng(SEED)
    n24 = 1 << 24
    finish_cases.append((
        "random_2p24_f32_finish",
        torch.from_numpy(rng.standard_normal(n24).astype(np.float32)).to(dev),
        torch.from_numpy(rng.permutation(n24).astype(np.int32)).to(dev),
        torch.from_numpy(rng.integers(0, 4, n24).astype(np.uint8)).to(dev)))
    flush = [torch.empty(48 << 20, dtype=torch.uint8, device=dev)
             for _ in range(2)]

    def pressure():
        flush[1].copy_(flush[0])

    libs = [(label, variant(label, subs)) for label, subs in VARIANTS]
    for label, x, idx in cases:
        n = idx.shape[0]
        want = rg.route_gather_finish_ref(x, idx)
        _assert_equal(f"{label} tree", rg.route_gather_finish(x, idx), want)
        _assert_equal(f"{label} first design", v1.route(x, idx), want)
        turns, flushed = [], []
        for which in ("first", "tree", "tree", "first"):
            fn = ((lambda: v1.route(x, idx)) if which == "first"
                  else (lambda: rg.route_gather_finish(x, idx)))
            turns.append(device_ms(fn, reps, "route_gather"))
            flushed.append(device_ms(fn, reps, "route_gather", pressure))
        out = torch.empty(n, dtype=torch.int32, device=dev)
        row = dict(
            n=n, first_tree_tree_first_ms=turns,
            first_tree_tree_first_after_flush_ms=flushed,
            copy_floor_ms=device_ms(lambda: out.copy_(idx), reps),
            index_select_ms=device_ms(
                lambda: torch.index_select(x, 0, idx), reps),
            bound_ms=bound_ms(n, x.element_size()))
        for vl, lib in libs:
            _assert_equal(f"{label} {vl}", lib.route(x, idx), want)
            row[f"{vl}_ms"] = device_ms(lambda: lib.route(x, idx), reps,
                                        "route_gather")
            row[f"{vl}_after_flush_ms"] = device_ms(
                lambda: lib.route(x, idx), reps, "route_gather", pressure)
        res[label] = row
        print(f"  {label}: {json.dumps(row)}")

    for label, x, idx, flags in finish_cases:
        n = idx.shape[0]
        kw = dict(flags=flags, exclude_self_loops=True, ident=0.0)
        kept = int(((flags & 1 != 0) & (flags & 2 == 0)).sum())
        want = rg.route_gather_finish_ref(x, idx, **kw)
        _assert_equal(f"{label} tree", rg.route_gather_finish(x, idx, **kw),
                      want)
        _assert_equal(f"{label} first design",
                      v1.finish_f32(x, idx, flags, True, 0.0), want)
        turns = []
        for which in ("first", "tree", "tree", "first"):
            fn = ((lambda: v1.finish_f32(x, idx, flags, True, 0.0))
                  if which == "first"
                  else (lambda: rg.route_gather_finish(x, idx, **kw)))
            turns.append(device_ms(fn, reps, "route_gather"))
        out = torch.empty(n, dtype=torch.int32, device=dev)
        row = dict(n=n, kept=kept, first_tree_tree_first_ms=turns,
                   copy_floor_ms=device_ms(lambda: out.copy_(idx), reps),
                   bound_ms=bound_ms(n, 4, kept))
        for vl, lib in libs:
            _assert_equal(f"{label} {vl}",
                          lib.finish_f32(x, idx, flags, True, 0.0), want)
            row[f"{vl}_ms"] = device_ms(
                lambda: lib.finish_f32(x, idx, flags, True, 0.0), reps,
                "route_gather")
        res[label] = row
        print(f"  {label}: {json.dumps(row)}")
    return res


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("-s", type=int, default=18)
    p.add_argument("--big", type=int, default=20)
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("exp_route: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    res = measure(args.s, args.big, args.reps)
    print(json.dumps({"card": smi, "route": res}))


if __name__ == "__main__":
    main()
