// and_popcount: the triangle count's intersection of bitmap rows, summed by
// chunk of edges.
//
//   for every chunk c < ceil(n / chunk):
//     out[c] = sum over i in [c * chunk, min((c + 1) * chunk, n))
//                  sum over w < words of popc(bits[u[i] * words + w]
//                                             & bits[v[i] * words + w])
//
// bits is a row-major int32 [rows, words] bitmap (one column block of the
// degree-oriented adjacency, models/tc._tc_build_bits); u and v are int32 row
// ids, each below rows, which the kernel does not check. The last chunk may
// be short.
//
// It has no TPU kernel to replace: the JAX package computes the same sums
// outside Pallas (vectorgraphlibrary_tpu/models/tc.py::_tc_block_count, one
// fori_loop over chunks of a gather, an AND and lax.population_count). In
// PyTorch, which has no popcount, that loop would make about a dozen
// [chunk, words] temporaries per chunk; here nothing is written but one
// int32 per chunk.
//
// What bounds it on Hopper. The contract's bound reads each input once: the
// bitmap, both index lists and the chunk sums. The rows are almost empty: a
// column block of RMAT-18 (16,384 columns, words = 512) holds about 1.7 set
// bits per row, so a design that ANDs both whole rows per pair (the first
// version: a warp per pair, 4 KiB read per pair) spends more than 99 % of
// its loads and popcounts on zero words, and is held up by the L2 traffic
// of hub rows read again for every pair. This design reads only what can
// add to the sum: the words of row v where row u is non-zero. Its own floor
// is one read of row u per run of pairs that share u, plus one 32-byte
// sector of row v per (pair, non-zero word of u) where those come from
// device memory; at the densest RMAT-18 block the items number 311 M (44
// per pair), and rows v of the hubs mostly come from L2.
//
// The design:
// - Pairs come sorted by u, then v (models/tc._oriented_simple_edges; the
//   presence filter keeps the order), so consecutive pairs share u. Each
//   chunk is one cluster of kBlocks blocks (Hopper thread block clusters),
//   and the cluster's 128 warps take the chunk's tiles of 32 pairs round
//   robin. A tile's lanes load its u and v once; a ballot over u marks the
//   runs of equal u in it.
// - Per run, the warp scans row u with 16-byte loads (two int4 per lane,
//   256 words per step; scalar loads where words is not a multiple of 4),
//   finds the non-zero words by ballot and compacts their (16-bit offset in
//   the window, value) in increasing word order into the warp's list in
//   shared memory. A row is taken in windows of at most kCap = 256 non-zero
//   words (then one step of 256 words) and 65,536 words, the run's pairs
//   walked once per window; the items stay the same. Small lists (1.5 KiB
//   a warp) leave most of the SM's 256 KB to L1, which keeps hub rows v: in
//   a comparison of variants on the H100, 16-bit offsets beat 32-bit word
//   indices, and 4 KiB lists, 8 items in flight per lane or fewer registers
//   for more blocks per SM were no faster. Consecutive tiles, on
//   neighbouring warps at about the same time, scan the same rows of a long
//   run, mostly from L2.
// - The work of a run is the list length L times its pairs: item k is pair
//   k / L (its v from that pair's lane by shuffle) and list entry k % L, and
//   the lanes take items k = lane, lane + 32, ... (4 in flight per lane),
//   stepping (pair, entry) without a division. A short list (u of low
//   degree) puts the lanes on different pairs, one sector of row v each; a
//   long list (a hub u) puts consecutive lanes on consecutive non-zero words
//   of one pair's row v, at increasing addresses. Tiles of 32 pairs spread a
//   hub's long run over all the cluster's warps (the first version gave each
//   warp a contiguous slice of the chunk, and a slice with hub runs held up
//   its whole chunk: 1.64 ms against 1.16 at the densest RMAT-18 block on
//   an H100 at 700 W). Pairs in any order stay correct; unsorted pairs
//   make runs of one and cost only speed.
// - Sums stay exact with no atomics: a lane adds __popc into an int32
//   register, the warp sums by shuffles, the block by shared memory, and
//   block 0 of the cluster adds the other blocks' sums from their shared
//   memory (distributed shared memory) and writes the chunk's sum: one write
//   per chunk. Integer sums are exact in any order, so the result equals the
//   plain version bit for bit. A chunk's sum is at most chunk times the
//   largest row's popcount, below 2^31 at every shape the triangle count
//   gives (models/tc.vgl_triangle_count checks it); so is every partial sum.
// - words of any size: a row of fewer than 256 words is one masked step.
//
// Plain C interface (loaded with ctypes): the entry returns cudaGetLastError()
// after the launch, runs on the given stream and allocates nothing.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBlocks = 8;            // blocks per chunk: one cluster
constexpr int kWarps = 16;            // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kCap = 256;             // list entries per warp
constexpr int kStep = 256;            // row words scanned per step
constexpr int kSpan = 65536;          // row words per window: 16-bit indices
constexpr int kUnroll = 4;            // items in flight per lane
constexpr unsigned kFull = 0xffffffffu;

// Append the non-zero words among w[0..3] (the lane's four consecutive row
// words, the first `w0` words past the window's start) to the warp's list at
// len, in increasing word order across the lanes; every lane gets the new
// length.
__device__ __forceinline__ void compact4(const int32_t w[4], int w0, int lane,
                                         uint16_t* lidx, int32_t* lval,
                                         int& len) {
  int cnt = (w[0] != 0) + (w[1] != 0) + (w[2] != 0) + (w[3] != 0);
  int incl = cnt;                       // inclusive prefix sum over lanes
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += t;
  }
  int pos = len + incl - cnt;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (w[k] != 0) {
      lidx[pos] = w0 + k;
      lval[pos] = w[k];
      ++pos;
    }
  }
  len += __shfl_sync(kFull, incl, 31);
}

__global__ void __cluster_dims__(kBlocks, 1, 1) __launch_bounds__(kThreads)
and_popcount_kernel(const int32_t* __restrict__ bits, int words,
                    const int32_t* __restrict__ u,
                    const int32_t* __restrict__ v, int64_t n, int chunk,
                    int32_t* __restrict__ out) {
  __shared__ uint16_t list_idx[kWarps][kCap];   // word - window start
  __shared__ int32_t list_val[kWarps][kCap];
  __shared__ int32_t warp_sum[kWarps];
  __shared__ int32_t block_sum;
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned rank = cluster.block_rank();
  const int64_t c = blockIdx.x / kBlocks;
  const int64_t c0 = c * chunk;
  const int64_t c1 = min(c0 + chunk, n);
  uint16_t* lidx = list_idx[warp];
  int32_t* lval = list_val[warp];
  const bool vec = (words & 3) == 0 && ((uintptr_t)bits & 15) == 0;
  int32_t acc = 0;

  // the chunk's tiles of 32 pairs, round robin over the cluster's warps
  for (int64_t tb = c0 + 32 * (int64_t)(rank * kWarps + warp); tb < c1;
       tb += 32 * kBlocks * kWarps) {
    const int tl = (int)min((int64_t)32, c1 - tb);
    const int my_u = lane < tl ? __ldg(u + tb + lane) : -1;
    const int my_v = lane < tl ? __ldg(v + tb + lane) : 0;
    const int prev_u = __shfl_up_sync(kFull, my_u, 1);
    // the first pair of every run of equal u in the tile
    unsigned starts = __ballot_sync(kFull,
                                    lane < tl && (lane == 0 || my_u != prev_u));
    while (starts) {
      const int r0 = __ffs(starts) - 1;
      starts &= starts - 1;
      const int cnt = (starts ? __ffs(starts) - 1 : tl) - r0;
      const int32_t* ru = bits + (int64_t)__shfl_sync(kFull, my_u, r0) * words;
      for (int w0 = 0; w0 < words;) {
        // fill the list with the next window of row u's non-zero words, at
        // most kSpan words from its start
        const int wbase = w0;
        int len = 0;
        for (; w0 < words && w0 - wbase < kSpan && len + kStep <= kCap;
             w0 += kStep) {
          int32_t a[4], b[4];
          const int wa = w0 + 4 * lane, wb = wa + 128;
          if (vec) {
            const int4 z = make_int4(0, 0, 0, 0);
            const int4 x = wa < words ? __ldg((const int4*)(ru + wa)) : z;
            const int4 y = wb < words ? __ldg((const int4*)(ru + wb)) : z;
            a[0] = x.x; a[1] = x.y; a[2] = x.z; a[3] = x.w;
            b[0] = y.x; b[1] = y.y; b[2] = y.z; b[3] = y.w;
          } else {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              a[k] = wa + k < words ? __ldg(ru + wa + k) : 0;
              b[k] = wb + k < words ? __ldg(ru + wb + k) : 0;
            }
          }
          const bool any = (a[0] | a[1] | a[2] | a[3] | b[0] | b[1] | b[2]
                            | b[3]) != 0;
          if (__ballot_sync(kFull, any) == 0) continue;
          compact4(a, wa - wbase, lane, lidx, lval, len);
          compact4(b, wb - wbase, lane, lidx, lval, len);
        }
        if (len == 0) continue;
        __syncwarp();
        // items k = lane, lane + 32, ... of the run: pair k / len (its v
        // from lane r0 + pair by shuffle), entry k % len
        const int dq = 32 / len, dr = 32 - dq * len;
        int pr = lane / len, t = lane - pr * len;
        for (int k0 = 0; k0 < cnt * len; k0 += 32 * kUnroll) {
          int32_t x[kUnroll];
#pragma unroll
          for (int k = 0; k < kUnroll; ++k) {
            const bool ok = pr < cnt;
            const int32_t* rv = bits + wbase + (int64_t)__shfl_sync(
                kFull, my_v, r0 + (ok ? pr : 0)) * words;
            x[k] = ok ? __ldg(rv + lidx[t]) & lval[t] : 0;
            pr += dq;
            t += dr;
            if (t >= len) {
              t -= len;
              ++pr;
            }
          }
#pragma unroll
          for (int k = 0; k < kUnroll; ++k) acc += __popc(x[k]);
        }
        __syncwarp();                   // the list is refilled next window
      }
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(kFull, acc, off);
  if (lane == 0) warp_sum[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t s = 0;
    for (int w = 0; w < kWarps; ++w) s += warp_sum[w];
    block_sum = s;
  }
  cluster.sync();                       // every block's sum is written
  if (rank == 0 && threadIdx.x == 0) {
    int32_t s = 0;
    for (int r = 0; r < kBlocks; ++r) s += *cluster.map_shared_rank(&block_sum, r);
    out[c] = s;
  }
  cluster.sync();                       // keep block_sum alive until read
}

}  // namespace

extern "C" {

int vgl_and_popcount(const void* bits, int words, const void* u,
                     const void* v, long long n, int chunk, void* out,
                     void* stream) {
  if (words <= 0 || chunk <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  const long long n_chunks = (n + chunk - 1) / chunk;
  if (n_chunks > 0x7fffffffLL / kBlocks) return (int)cudaErrorInvalidValue;
  if (n_chunks == 0) return (int)cudaGetLastError();
  and_popcount_kernel<<<(unsigned)(n_chunks * kBlocks), kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const int32_t*)bits, words, (const int32_t*)u, (const int32_t*)v, n,
      chunk, (int32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
