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
// [chunk, words] temporaries per chunk (64 MiB each at the RMAT-18 shapes,
// chunk = 32,768 and words = 512); here each pair of rows is read once and
// nothing else is written but one int32 per chunk.
//
// What bounds it on Hopper: bytes. Every edge reads its two rows, 8 * words
// bytes (4 KiB at words = 512), and the rows of a hub are read again for every
// edge that touches it, so the floor is 2 * n * words * 4 B over the 3.35 TB/s
// of device memory (L2 catches some of the rereads of hub rows). The design
// keeps many loads in flight: one block of 1,024 threads per chunk, one warp
// per edge, each lane reading every 32nd word of both rows (a warp reads 128
// contiguous bytes of a row per load) with 4 words of each row in flight, and
// the warps of the block walking the chunk's edges in turn. A lane adds
// __popc of its ANDs into an int32 register, the warp sums by shuffles, the
// block by shared memory, and thread 0 writes the chunk's sum: one write per
// chunk and no atomics. Integer sums are exact in any order, so the result
// equals the plain version bit for bit. A chunk's sum is at most chunk times
// the largest row's popcount, below 2^31 at every shape the triangle count
// gives (models/tc.vgl_triangle_count checks it). First version: a lane idles
// where words < 32 (not the main path's shape).
//
// Plain C interface (loaded with ctypes): the entry returns cudaGetLastError()
// after the launch, runs on the given stream and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;

__global__ void __launch_bounds__(kThreads)
and_popcount_kernel(const int32_t* __restrict__ bits, int words,
                    const int32_t* __restrict__ u,
                    const int32_t* __restrict__ v, int64_t n, int chunk,
                    int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t begin = (int64_t)blockIdx.x * chunk;
  const int64_t end = min(begin + chunk, n);
  int32_t acc = 0;
  for (int64_t i = begin + warp; i < end; i += kWarps) {
    const int32_t* ru = bits + (int64_t)__ldg(u + i) * words;
    const int32_t* rv = bits + (int64_t)__ldg(v + i) * words;
    int w = lane;
    // kUnroll words of each row in flight per lane
    for (; w + 32 * (kUnroll - 1) < words; w += 32 * kUnroll) {
      int32_t a[kUnroll], b[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        a[k] = __ldg(ru + w + 32 * k);
        b[k] = __ldg(rv + w + 32 * k);
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) acc += __popc(a[k] & b[k]);
    }
    for (; w < words; w += 32) acc += __popc(__ldg(ru + w) & __ldg(rv + w));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  __shared__ int32_t part[kWarps];
  if (lane == 0) part[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = part[lane];          // kWarps == 32: one value per lane
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) out[blockIdx.x] = acc;
  }
}

static_assert(kWarps == 32, "the block reduction takes one value per lane");

}  // namespace

extern "C" {

int vgl_and_popcount(const void* bits, int words, const void* u,
                     const void* v, long long n, int chunk, void* out,
                     void* stream) {
  if (words <= 0 || chunk <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  const long long n_chunks = (n + chunk - 1) / chunk;
  if (n_chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (n_chunks == 0) return (int)cudaGetLastError();
  and_popcount_kernel<<<(unsigned)n_chunks, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const int32_t*)bits, words, (const int32_t*)u, (const int32_t*)v, n,
      chunk, (int32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
