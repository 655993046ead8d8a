// Beneš-network router for static permutations (host C++, built by the host
// compiler, loaded with ctypes). A copy of the router in native/benes.cpp of
// the JAX package, so that the port builds and loads its own library; its
// threads are std::threads in place of OpenMP.
//
// The port executes a route as a gather index (ops/route.py), but a
// persisted graph (graph/persistence.py) stores each route as the network's
// stage masks and lane indices, in the JAX package's format. This router
// gives those masks for a permutation when a graph is saved.
//
// Network over N = 2^k slots:
//   input exchanges  at distances N/2, N/4, ..., 128
//   one arbitrary intra-128 lane shuffle (the collapsed middle of the network)
//   output exchanges at distances 128, ..., N/4, N/2.
// Masks come from the classic looping (2-colouring) algorithm, O(N log N).
//
// C ABI:
//   benes_route(n, perm, in_masks, out_masks, lane_idx) -> 0 on success
//     n         : power of two, >= 128
//     perm      : int64[n], perm[dst] = src  (route(x)[dst] == x[perm[dst]])
//     in_masks  : uint8[levels*n]  (levels = log2(n) - 7), stage order top-down
//     out_masks : uint8[levels*n]
//     lane_idx  : int32[n], per-128-block gather indices (values 0..127)
//   returns 1 for a bad n, 2 for a perm value outside [0, n).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

// 2-colour one block [lo, lo+m) given q (position -> block-local destination).
// side[a] = 0 (upper subnet) / 1 (lower). qinv is scratch of size >= m.
void color_block(const int32_t* q, int64_t lo, int32_t m, int8_t* side,
                 int32_t* qinv) {
  const int32_t h = m / 2;
  for (int32_t j = 0; j < m; ++j) qinv[q[lo + j]] = j;  // block-local
  for (int32_t j = 0; j < m; ++j) side[j] = -1;
  for (int32_t a0 = 0; a0 < h; ++a0) {
    if (side[a0] != -1) continue;
    int32_t a = a0;
    int8_t s = 0;
    while (side[a] == -1) {
      side[a] = s;
      const int32_t p = a ^ h;          // input partner
      side[p] = (int8_t)(1 - s);
      const int32_t b = q[lo + p];      // p's destination
      a = qinv[b ^ h];                  // shares p's output switch: side s
    }
  }
}

}  // namespace

extern "C" int benes_route(int64_t n, const int64_t* perm, uint8_t* in_masks,
                           uint8_t* out_masks, int32_t* lane_idx) {
  if (n < 128 || (n & (n - 1)) != 0) return 1;
  int k = 0;
  while ((int64_t(1) << k) < n) ++k;
  const int levels = k - 7;  // block sizes 2^k .. 2^8

  std::vector<int32_t> q(n);       // q[pos] = block-local destination of element
  for (int64_t i = 0; i < n; ++i) {
    if (perm[i] < 0 || perm[i] >= n) return 2;
    q[perm[i]] = (int32_t)i;
  }
  // Blocks within a level are disjoint, so they run in parallel on
  // std::threads (no OpenMP runtime needed), each thread with block-sized
  // scratch, taking blocks from a shared counter. The first level is one
  // n-sized block, whose cycle-following loop is sequential.
  const int64_t hw = std::max<int64_t>(1, std::thread::hardware_concurrency());
  for (int lev = 0; lev < levels; ++lev) {
    const int64_t m = int64_t(1) << (k - lev);
    const int32_t h = (int32_t)(m / 2);
    const int64_t nblocks = n / m;
    uint8_t* im = in_masks + (int64_t)lev * n;
    uint8_t* om = out_masks + (int64_t)lev * n;
    std::atomic<int64_t> next(0);
    auto work = [&]() {
      std::vector<int32_t> qinv((size_t)m);
      std::vector<int8_t> side((size_t)m);
      for (int64_t b = next++; b < nblocks; b = next++) {
        const int64_t lo = b * m;
        color_block(q.data(), lo, (int32_t)m, side.data(), qinv.data());
        // masks + apply input swaps + fill output masks + reduce q to subnets
        for (int32_t j = 0; j < h; ++j) {
          const uint8_t swap = (uint8_t)(side[j] == 1);
          im[lo + j] = swap;
          im[lo + j + h] = swap;
          if (swap) {
            const int32_t t = q[lo + j];
            q[lo + j] = q[lo + j + h];
            q[lo + j + h] = t;
          }
        }
        // upper subnet at [lo, lo+h): exit slot q%h; out swap iff dest >= h
        for (int32_t j = 0; j < h; ++j) {
          const int32_t d = q[lo + j];
          const uint8_t swap = (uint8_t)((d & h) != 0);
          om[lo + (d & (h - 1))] = swap;
          om[lo + (d & (h - 1)) + h] = swap;
        }
        for (int32_t j = 0; j < (int32_t)m; ++j) q[lo + j] &= (h - 1);
      }
    };
    std::vector<std::thread> pool;
    for (int64_t t = 1; t < std::min(nblocks, hw); ++t) pool.emplace_back(work);
    work();
    for (auto& th : pool) th.join();
  }

  // base case: blocks of 128 — arbitrary lane shuffle, out[b] = in[lane_idx[b]]
  for (int64_t lo = 0; lo < n; lo += 128) {
    for (int32_t j = 0; j < 128; ++j) lane_idx[lo + q[lo + j]] = j;
  }
  return 0;
}
