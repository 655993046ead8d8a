// scatter_combine: combine int32 messages into an int32 vertex array, or f32
// messages into an f32 one.
//
//   for every i < n with 0 <= idx[i] < n_out:
//     out[idx[i]] = op(out[idx[i]], msg[i])    op in {min, max, or, add};
//                                              f32: min, max
//
// Messages whose index falls outside [0, n_out) are dropped. `msg` may be
// NULL, and then every message is the constant `msg_const`.
//
// Replaces the TPU kernel of apps/exp_push.py (make_c / _kern): the OR of a
// one-hot bit into a VMEM-resident int32 [V/128, 128] array, one destination
// at a time, in a sequential grid over SMEM blocks of 4096 destinations
// (out-of-range destinations dropped). That is the case op = or, msg = 1.
// In the port the same kernel is the scatter stage of the generic sparse
// push (ops/advance.advance_push_sparse): the owner mark (max) and the
// combine, where the JAX package uses XLA's scatter, and the int32 add of
// Monoid.scatter_at("add"); its sorted build makes the triangle count's
// bitmaps (models/tc._tc_build_bits: one bit added per deduplicated edge, so
// the add is an or). The BFS push runs csrc/push_expand.cu instead.
//
// Two designs, one per kind of caller.
//
// The general entries (vgl_scatter_combine_i32, _f32): messages in any
// order, combined into a target the caller owns, one atomic per message in a
// grid-stride loop. At the sparse push's shapes the target (4 MB at v_pad =
// 2^20) lives in the 50 MB L2, so the atomics resolve there; 2^16 messages
// into 2^20 is 8 bytes per message plus the target, 0.0027 ms at 3.35 TB/s
// copying and less in place, below one launch's latency. So what bounds those
// calls is the launch itself: the host's checks and the ctypes call in front
// of it (ops/cuda/scatter_combine.py keeps that path short) and the card's
// launch latency. The TPU needed a sequential grid because its VMEM row
// update is a read-modify-write; here atomicMin/atomicMax/atomicOr commute
// on int32, so the result does not depend on the order of the threads: it is
// the same on every run and equals the plain version bit for bit. So does
// atomicAdd on int32: a sum modulo 2^32 is exact in any order. There is no
// f32 add: float sums taken by atomics round in the order the threads
// arrive, which changes from run to run, so the wrapper raises for it. The
// return value of each int32 atomic is unused, so it compiles to a
// fire-and-forget reduction (RED). f32 min and max combine by the port's
// one f32 rule (f32_minmax.cuh) in a compare-and-swap loop: integer
// atomics on the floats' bits put a positive NaN above +inf, so a min
// dropped it.
//
// The sorted build (vgl_scatter_build_sorted_i32): messages whose indices
// never decrease, combined into a target that the entry makes itself,
//
//   out[w] = identity(op) op (op over i with idx[i] == w of msg[i])
//
// for every w < n_out: the triangle count's bitmaps (models/tc.
// _tc_build_bits, the function of the JAX package's jnp.zeros(...).at[u,
// word].add(bit, mode="drop")), whose oriented edges arrive sorted by u,
// then v, so that idx = u * words + (v >> 5) never decreases. A bitmap at
// RMAT-18 is 537 MB (int32 [262,145, 512]) and takes about 2.9 M bits at
// its densest column block: ten times L2, and some 160 bits per 7,168
// words. Built as a zero fill and then atomics into it, it is written
// twice, and the atomics wait for the whole fill. Here each block owns a
// span of kSpan consecutive words: it finds its messages [lo, hi) by two
// block-wide searches over idx (messages outside [0, n_out) sit at the two
// ends of a sorted idx and fall outside every span), sets a tile of shared
// memory to the identity, combines its messages into the tile with
// shared-memory atomics (they commute, so the tile is bit-exact in any
// order) and writes the tile out with coalesced 16-byte stores. Every word
// of the target is written exactly once and read never, with no fill pass
// and no global atomic, so the bound is the target written once plus 8
// bytes per message: at the densest RMAT-18 block 536,872,960 + 8 x
// 2,933,910 bytes, 0.1673 ms at 3.35 TB/s; a span with no message writes
// the identity at the rate of a fill. What keeps a dense block above the
// bound is the searches' and the messages' latency before a block's
// writes, which other blocks' writes must cover: so the tile is 28 KB, for
// 8 blocks an SM where 32 KB gave 7, and the stores are evict-first, so
// that idx and msg stay in L2 for the searches. Tried on the H100 and
// dropped (PERF.md, Findings): one block per run of spans with one search
// (its spans' loads wait one after another: slower at every density), the
// identity written first and the hit words patched after (slower where
// the messages are dense), and the first messages loaded before the tile
// is set (no gain). The entry does not check the order (that would need a
// read back on the host): a caller passes a non-decreasing idx, the plain
// version raises on a decreasing one, and chip_smoke.py checks the
// triangle count's once.
//
// Plain C interface (loaded with ctypes): each entry returns
// cudaGetLastError() after the launch, runs on the given stream and
// allocates nothing; `out` is the target itself (scatter_combine_) or the
// wrapper's copy of it (scatter_combine), or the new tensor that the sorted
// build fills (scatter_combine_sorted).

#include <cuda_runtime.h>
#include <stdint.h>

#include "f32_minmax.cuh"

namespace {

enum Op { OP_MIN = 0, OP_MAX = 1, OP_OR = 2, OP_ADD = 3 };

template <int OP>
__global__ void scatter_combine_kernel(int32_t* __restrict__ out,
                                       uint32_t n_out,
                                       const int32_t* __restrict__ idx,
                                       const int32_t* __restrict__ msg,
                                       int32_t msg_const, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    // one unsigned test drops both negative and too-large indices
    const uint32_t d = (uint32_t)__ldg(idx + i);
    if (d >= n_out) continue;
    const int32_t m = msg != nullptr ? __ldg(msg + i) : msg_const;
    if (OP == OP_MIN) atomicMin(out + d, m);
    if (OP == OP_MAX) atomicMax(out + d, m);
    if (OP == OP_OR) atomicOr(out + d, m);
    if (OP == OP_ADD) atomicAdd(out + d, m);
  }
}

// f32 min/max: a compare-and-swap loop that combines by the port's one f32
// rule (f32_minmax.cuh). The rule is a total order of the bit patterns, so
// the result is the same in any order of the threads. A message that does
// not change the target's value (the usual case once a sweep's distances
// settle) ends after one read: the target only moves down (min) or up
// (max) that order, so a message that does not beat a value read once
// never beats a later one.
template <bool IS_MIN>
__global__ void scatter_combine_f32_kernel(float* __restrict__ out,
                                           uint32_t n_out,
                                           const int32_t* __restrict__ idx,
                                           const float* __restrict__ msg,
                                           float msg_const, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint32_t d = (uint32_t)__ldg(idx + i);
    if (d >= n_out) continue;
    const float m = msg != nullptr ? __ldg(msg + i) : msg_const;
    unsigned int* word = (unsigned int*)(out + d);
    unsigned int seen = *(volatile unsigned int*)word;
    while (true) {
      const float cur = __uint_as_float(seen);
      const unsigned int want =
          __float_as_uint(IS_MIN ? vgl_fmin(cur, m) : vgl_fmax(cur, m));
      if (want == seen) break;
      const unsigned int was = atomicCAS(word, seen, want);
      if (was == seen) break;
      seen = was;
    }
  }
}

constexpr int kSortedThreads = 256;
// words a block of the sorted build owns: a 28 KB tile, so that 8 blocks
// of 256 threads (the SM's 2,048) fit an SM's shared memory
constexpr int kSpan = 7168;

template <int OP>
__device__ __forceinline__ int32_t identity() {
  if (OP == OP_MIN) return INT32_MAX;
  if (OP == OP_MAX) return INT32_MIN;
  return 0;                                // or, add
}

// first i in [0, n) with a[i] >= key, for two keys at once (n if none; a
// non-decreasing) by the whole block: each round every thread tests one
// sample of each remaining range and __syncthreads_count says how many
// samples are below the key (a prefix, since a is sorted), which cuts the
// range by kSortedThreads: three rounds for 16.7 M entries, one L2 round
// trip each, where one thread's binary search takes log2(n) dependent loads
// (the lower-bound form of csrc/push_expand.cu's block_upper_bound).
// Block-uniform.
__device__ __forceinline__ void block_lower_bounds(const int32_t* a,
                                                   long long n, long long k0,
                                                   long long k1,
                                                   long long* r0,
                                                   long long* r1) {
  long long lo0 = 0, hi0 = n, lo1 = 0, hi1 = n;   // answers in [lo, hi]
  while (lo0 < hi0 || lo1 < hi1) {
    const long long s0 = (hi0 - lo0 + kSortedThreads - 1) / kSortedThreads;
    const long long s1 = (hi1 - lo1 + kSortedThreads - 1) / kSortedThreads;
    const long long i0 = lo0 + threadIdx.x * s0;
    const long long i1 = lo1 + threadIdx.x * s1;
    const bool b0 = i0 < hi0 && (long long)__ldg(a + i0) < k0;
    const bool b1 = i1 < hi1 && (long long)__ldg(a + i1) < k1;
    const int below0 = __syncthreads_count(b0);
    const int below1 = __syncthreads_count(b1);
    // the samples below the key: the answer is past the last of them and
    // at most the first sample at or above it
    if (lo0 < hi0) {
      const long long nl = below0 ? lo0 + (below0 - 1) * s0 + 1 : lo0;
      hi0 = min(hi0, lo0 + below0 * s0);
      lo0 = nl;
    }
    if (lo1 < hi1) {
      const long long nl = below1 ? lo1 + (below1 - 1) * s1 + 1 : lo1;
      hi1 = min(hi1, lo1 + below1 * s1);
      lo1 = nl;
    }
  }
  *r0 = lo0;
  *r1 = lo1;
}

// one block per span of kSpan words of out: its messages combined into a
// shared tile set to the identity, then the tile written out by streaming
// (evict-first) stores, which leave L2 to idx and msg
template <int OP>
__global__ void __launch_bounds__(kSortedThreads)
scatter_build_sorted_kernel(int32_t* __restrict__ out, long long n_out,
                            const int32_t* __restrict__ idx,
                            const int32_t* __restrict__ msg,
                            int32_t msg_const, long long n) {
  __shared__ __align__(16) int32_t tile[kSpan];
  const long long w0 = (long long)blockIdx.x * kSpan;
  const int len = (int)min((long long)kSpan, n_out - w0);
  long long lo, hi;
  block_lower_bounds(idx, n, w0, w0 + len, &lo, &hi);
  const int32_t id = identity<OP>();
  const int4 id4 = make_int4(id, id, id, id);
  int4* o4 = reinterpret_cast<int4*>(out + w0);
  const int n4 = len / 4;
  if (lo == hi) {                          // no message: the identity
    for (int i = threadIdx.x; i < n4; i += kSortedThreads) __stcs(o4 + i, id4);
    for (int i = 4 * n4 + threadIdx.x; i < len; i += kSortedThreads)
      out[w0 + i] = id;
    return;
  }
  for (int i = threadIdx.x; i < kSpan / 4; i += kSortedThreads)
    reinterpret_cast<int4*>(tile)[i] = id4;
  __syncthreads();
  for (long long i = lo + threadIdx.x; i < hi; i += kSortedThreads) {
    const int w = (int)((long long)__ldg(idx + i) - w0);
    const int32_t m = msg != nullptr ? __ldg(msg + i) : msg_const;
    if (OP == OP_MIN) atomicMin(tile + w, m);
    if (OP == OP_MAX) atomicMax(tile + w, m);
    if (OP == OP_OR) atomicOr(tile + w, m);
    if (OP == OP_ADD) atomicAdd(tile + w, m);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n4; i += kSortedThreads)
    __stcs(o4 + i, reinterpret_cast<const int4*>(tile)[i]);
  for (int i = 4 * n4 + threadIdx.x; i < len; i += kSortedThreads)
    out[w0 + i] = tile[i];
}

// blocks for n messages: enough to fill 132 SMs many times over; the
// grid-stride loop covers the rest
unsigned grid_for(long long n, int threads) {
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  return (unsigned)blocks;
}

}  // namespace

extern "C" {

int vgl_scatter_combine_i32(void* out, long long n_out, const void* idx,
                            const void* msg, int msg_const, long long n, int op,
                            void* stream) {
  if (n_out < 0 || n_out > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (n <= 0 || n_out == 0) return (int)cudaGetLastError();
  const int threads = 256;
  const unsigned blocks = grid_for(n, threads);
  cudaStream_t s = (cudaStream_t)stream;
  int32_t* o = (int32_t*)out;
  const int32_t* ip = (const int32_t*)idx;
  const int32_t* mp = (const int32_t*)msg;
  const uint32_t no = (uint32_t)n_out;
  switch (op) {
    case OP_MIN:
      scatter_combine_kernel<OP_MIN><<<blocks, threads, 0, s>>>(
          o, no, ip, mp, (int32_t)msg_const, n);
      break;
    case OP_MAX:
      scatter_combine_kernel<OP_MAX><<<blocks, threads, 0, s>>>(
          o, no, ip, mp, (int32_t)msg_const, n);
      break;
    case OP_OR:
      scatter_combine_kernel<OP_OR><<<blocks, threads, 0, s>>>(
          o, no, ip, mp, (int32_t)msg_const, n);
      break;
    case OP_ADD:
      scatter_combine_kernel<OP_ADD><<<blocks, threads, 0, s>>>(
          o, no, ip, mp, (int32_t)msg_const, n);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// f32: op is OP_MIN or OP_MAX.
int vgl_scatter_combine_f32(void* out, long long n_out, const void* idx,
                            const void* msg, float msg_const, long long n,
                            int op, void* stream) {
  if (n_out < 0 || n_out > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (op != OP_MIN && op != OP_MAX) return (int)cudaErrorInvalidValue;
  if (n <= 0 || n_out == 0) return (int)cudaGetLastError();
  const int threads = 256;
  const unsigned blocks = grid_for(n, threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (op == OP_MIN)
    scatter_combine_f32_kernel<true><<<blocks, threads, 0, s>>>(
        (float*)out, (uint32_t)n_out, (const int32_t*)idx, (const float*)msg,
        msg_const, n);
  else
    scatter_combine_f32_kernel<false><<<blocks, threads, 0, s>>>(
        (float*)out, (uint32_t)n_out, (const int32_t*)idx, (const float*)msg,
        msg_const, n);
  return (int)cudaGetLastError();
}

// The sorted build: out (int32 [n_out], 16-byte aligned) made whole from
// messages whose idx never decreases; op as vgl_scatter_combine_i32.
int vgl_scatter_build_sorted_i32(void* out, long long n_out, const void* idx,
                                 const void* msg, int msg_const, long long n,
                                 int op, void* stream) {
  if (n_out < 0 || n_out > 0x7fffffffLL || n < 0 ||
      ((uintptr_t)out & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (n_out == 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((n_out + kSpan - 1) / kSpan);
  cudaStream_t s = (cudaStream_t)stream;
  int32_t* o = (int32_t*)out;
  const int32_t* ip = (const int32_t*)idx;
  const int32_t* mp = (const int32_t*)msg;
  switch (op) {
    case OP_MIN:
      scatter_build_sorted_kernel<OP_MIN><<<blocks, kSortedThreads, 0, s>>>(
          o, n_out, ip, mp, (int32_t)msg_const, n);
      break;
    case OP_MAX:
      scatter_build_sorted_kernel<OP_MAX><<<blocks, kSortedThreads, 0, s>>>(
          o, n_out, ip, mp, (int32_t)msg_const, n);
      break;
    case OP_OR:
      scatter_build_sorted_kernel<OP_OR><<<blocks, kSortedThreads, 0, s>>>(
          o, n_out, ip, mp, (int32_t)msg_const, n);
      break;
    case OP_ADD:
      scatter_build_sorted_kernel<OP_ADD><<<blocks, kSortedThreads, 0, s>>>(
          o, n_out, ip, mp, (int32_t)msg_const, n);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
