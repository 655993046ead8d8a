"""PyTorch port, csrc/route_gather.cu's partition of a route's slots among
its threads, on the CPU: a numpy model of `launch` (the head before the
output's first 16-byte boundary, one vector item of V = 16 / sizeof(T)
slots per thread, the tail past the last whole item, the grid) and of the
kernel's thread-to-slot map, with the block size read from the source.
Every slot is written exactly once, every vector store is 16-byte aligned,
and the grid is the one wave the source note states at the paths' sizes."""
import re
from pathlib import Path

import numpy as np
import pytest

SOURCE = (Path(__file__).resolve().parents[1] / "vectorgraphlibrary_tpu_torch"
          / "csrc" / "route_gather.cu").read_text()
THREADS = int(re.search(r"constexpr int kThreads = (\d+);", SOURCE).group(1))
NS = [1, 3, 15, 16, 17, 4095, 1 << 18, (1 << 20) + 5]


def launch_model(n: int, out_addr: int, size: int):
    """(head, nvec, blocks) as launch() computes them."""
    v = 16 // size
    head = min(n, ((16 - (out_addr & 15)) & 15) // size)
    nvec = (n - head) // v
    work = max(nvec, head + (n - head - nvec * v))
    return head, nvec, (work + THREADS - 1) // THREADS


def slots_written(n: int, out_addr: int, size: int) -> np.ndarray:
    """How often each slot is written, thread by thread as the kernel
    writes: vector item t (t < nvec) at head + t V, scalar slot t of the
    head and tail (t < head + tail)."""
    v = 16 // size
    head, nvec, blocks = launch_model(n, out_addr, size)
    t = np.arange(blocks * THREADS)
    count = np.zeros(n, np.int64)
    base = head + t[t < nvec] * v
    assert ((out_addr + base * size) % 16 == 0).all()
    np.add.at(count, (base[:, None] + np.arange(v)).ravel(), 1)
    tail = head + nvec * v
    ts = t[t < head + (n - tail)]
    np.add.at(count, np.where(ts < head, ts, tail + ts - head), 1)
    return count


@pytest.mark.parametrize("size", [4, 1])
@pytest.mark.parametrize("n", NS)
def test_every_slot_written_once(n, size):
    # every element-aligned start of the output within 16 bytes
    for out_addr in range(0, 16, size):
        count = slots_written(n, 4096 + out_addr, size)
        assert (count == 1).all(), (out_addr, np.flatnonzero(count != 1)[:8])


@pytest.mark.parametrize("size", [4, 1])
@pytest.mark.parametrize("n", NS)
def test_each_warp_gathers_its_tile_once(n, size):
    """The slots a warp's lanes gather in transposed order are exactly the
    slots its items store, a partial last warp included."""
    v = 16 // size
    assert "const int s = 32 * k + lane;" in SOURCE
    for out_addr in (0, 4):
        head, nvec, _ = launch_model(n, out_addr, size)
        for first in range(0, nvec, 32):
            items = min(32, nvec - first)
            valid = items * v
            s = (32 * np.arange(v)[:, None] + np.arange(32)[None, :]).ravel()
            gathered = np.sort(s[s < valid])
            stored = (np.arange(items)[:, None] * v
                      + np.arange(v)[None, :]).ravel()
            assert np.array_equal(gathered, np.sort(stored))


def test_one_wave_at_the_paths_sizes():
    """At 2^18 4-byte slots 256 blocks (2 an SM of the H100's 132), at 2^20
    4-byte slots 1,024, at 2^20 bytes 256; no launch needs a loop."""
    assert THREADS == 256
    assert launch_model(1 << 18, 0, 4) == (0, 1 << 16, 256)
    assert launch_model(1 << 20, 0, 4) == (0, 1 << 18, 1024)
    assert launch_model(1 << 20, 0, 1) == (0, 1 << 16, 256)
    assert launch_model(1 << 29, 0, 4)[2] < 2**31 - 1
