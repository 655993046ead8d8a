// pull_rows: the feature-row pull of GraphSAGE's aggregation, a sparse-dense
// product with ones over one CSR.
//
//   out[v, :] = sum over k in [row_ptr[v], row_ptr[v+1]) of x[col_idx[k], :]
//
// x is f32 [n_x, F] and out f32 [n_rows, F], both row-major; an empty row
// gives zeros. The forward pass of the aggregation runs it over the
// direction's CSR, its gradient over the transposed CSR (models/gnn.py).
//
// No TPU kernel: the JAX package aggregates outside Pallas
// (vectorgraphlibrary_tpu/models/gnn.py:29-80, aggregate_sum_count: jnp.take
// of the neighbours' rows per degree tile, then sums over the tiles). On this
// card the plain version of that gather writes an [E, F] array (17.2 GB at
// RMAT-20 and F = 256) and reads it back; this kernel keeps every sum in
// registers.
//
// What bounds it on Hopper: memory. Each input read once and the output
// written once is (n_rows + 1) * 4 + E * 4 + n_x * F * 4 + n_rows * F * 4
// bytes, but each edge reads the whole F-wide row of its source, E * F * 4
// bytes in all, and x (420 MB at RMAT-20 and F = 100) does not fit the 50 MB
// L2: what the rows of often-read sources keep in L2 is what brings the
// kernel under the second figure.
//
// Design: lanes over the features, edges in flight. A feature chunk is 32
// lanes of VEC floats (VEC = 4, 16-byte loads, when F % 4 == 0 and x and out
// are 16-byte aligned; else 1). One warp takes one (row, chunk): it loads 32
// col_idx at a time (one coalesced load), hands them out by shuffle and
// keeps kUnroll rows' loads in flight per lane. A row of more than hub_min
// edges would make a straggler of its warp (RMAT-20's largest in-degree is
// tens of thousands), so hub_rows lists those rows (any order; the wrapper's
// RowCSR makes the list from row_ptr once per CSR) and each (hub row, chunk) gets a block of
// kWarps warps that take the row's 32-edge batches round robin, then add
// their partial sums through shared memory. The warp path skips those rows.
//
// No atomics: each output element is summed by one warp in edge order, or by
// a block's warps, each in edge order, then warp by warp in a fixed order,
// so two runs give the same bits. Every sum is compensated (kahan below),
// and the block's merge adds each warp's compensation too.
// Shared memory: kWarps x 32 partial sums with their compensations, 16 KB
// with VEC = 4.
//
// Plain C interface (loaded with ctypes): the entry returns
// cudaGetLastError() after the launch, runs on the given stream and
// allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;          // rows in flight per lane; divides 32

__device__ __forceinline__ float zero_of(float) { return 0.f; }
__device__ __forceinline__ float4 zero_of(float4) {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// A compensated (Kahan) sum: c keeps the low bits each addition loses, so
// the error stays near one rounding of the sum however many edges a row has,
// where a plain f32 sum drifts with their number (RMAT-20's rows run to
// 69,143 edges). Four flops per value instead of one cost nothing here: the
// kernel waits on memory. No product is involved, so nvcc's contraction
// into fused multiply-adds cannot change it.
__device__ __forceinline__ void kahan(float& s, float& c, float y) {
  y -= c;
  const float t = s + y;
  c = (t - s) - y;
  s = t;
}
template <typename V> struct Sum {
  V s, c;
};
__device__ __forceinline__ void add_to(Sum<float>& a, float y) {
  kahan(a.s, a.c, y);
}
__device__ __forceinline__ void add_to(Sum<float4>& a, float4 y) {
  kahan(a.s.x, a.c.x, y.x);
  kahan(a.s.y, a.c.y, y.y);
  kahan(a.s.z, a.c.z, y.z);
  kahan(a.s.w, a.c.w, y.w);
}
__device__ __forceinline__ float neg(float y) { return -y; }
__device__ __forceinline__ float4 neg(float4 y) {
  return make_float4(-y.x, -y.y, -y.z, -y.w);
}
// Adds the compensated sum b (its value is b.s - b.c) to a.
template <typename V>
__device__ __forceinline__ void merge(Sum<V>& a, const Sum<V>& b) {
  add_to(a, b.s);
  add_to(a, neg(b.c));
}

// The sum over the 32-edge batches at k, k + stride, ... below end of
// x[col_idx[.], f], in edge order; lane f of the chunk (has_f: f < F / VEC).
// Every lane of the warp calls it with the same k, end and stride.
template <typename V>
__device__ __forceinline__ Sum<V> sum_batches(
    const int32_t* __restrict__ col_idx, const V* __restrict__ x, size_t fv,
    int f, bool has_f, int k, int end, int stride, int lane) {
  Sum<V> acc = {zero_of(V()), zero_of(V())};
  for (; k < end; k += stride) {
    const int nb = min(32, end - k);
    const int c = lane < nb ? __ldg(col_idx + k + lane) : 0;
    for (int j = 0; j < nb; j += kUnroll) {
      V v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int cu = __shfl_sync(0xffffffffu, c, j + u);
        v[u] = (j + u < nb && has_f) ? __ldg(x + (size_t)cu * fv + f)
                                     : zero_of(V());
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (j + u < nb) add_to(acc, v[u]);
    }
  }
  return acc;
}

// Blocks [0, n_hub * n_chunks): one (hub row, chunk) each. The rest: kWarps
// (row, chunk) items each, row-major over rows [0, n_rows).
// Two blocks per SM (at most 64 registers a thread), as the kernel had
// before its sums were compensated.
template <typename V>
__global__ void __launch_bounds__(kThreads, 2)
pull_rows_kernel(const int32_t* __restrict__ row_ptr,
                 const int32_t* __restrict__ col_idx,
                 const V* __restrict__ x, V* __restrict__ out, int n_rows,
                 int fv, int n_chunks, const int32_t* __restrict__ hub_rows,
                 int n_hub, int hub_min) {
  __shared__ Sum<V> s_part[kWarps][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long b = blockIdx.x;
  const long long hub_blocks = (long long)n_hub * n_chunks;
  if (b < hub_blocks) {
    const int row = __ldg(hub_rows + b / n_chunks);
    const int f = (int)(b % n_chunks) * 32 + lane;
    const int start = __ldg(row_ptr + row), end = __ldg(row_ptr + row + 1);
    if (end - start <= hub_min) return;   // the warp path has it; uniform
    const bool has_f = f < fv;
    s_part[warp][lane] = sum_batches<V>(col_idx, x, (size_t)fv, f, has_f,
                                        start + warp * 32, end, 32 * kWarps,
                                        lane);
    __syncthreads();
    if (warp == 0 && has_f) {
      Sum<V> t = s_part[0][lane];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) merge(t, s_part[w][lane]);
      out[(size_t)row * fv + f] = t.s;
    }
    return;
  }
  const long long item = (b - hub_blocks) * kWarps + warp;
  const long long row = item / n_chunks;
  if (row >= n_rows) return;
  const int f = (int)(item % n_chunks) * 32 + lane;
  const int start = __ldg(row_ptr + row), end = __ldg(row_ptr + row + 1);
  if (end - start > hub_min) return;       // a hub block has it; uniform
  const bool has_f = f < fv;
  const Sum<V> acc = sum_batches<V>(col_idx, x, (size_t)fv, f, has_f, start,
                                    end, 32, lane);
  if (has_f) out[(size_t)row * fv + f] = acc.s;
}

template <typename V>
int launch(const void* row_ptr, const void* col_idx, const void* x,
           void* out, int n_rows, int fv, const void* hub_rows, int n_hub,
           int hub_min, cudaStream_t st) {
  const int n_chunks = (fv + 31) / 32;
  const long long blocks = (long long)n_hub * n_chunks
      + ((long long)n_rows * n_chunks + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  pull_rows_kernel<V><<<(unsigned)blocks, kThreads, 0, st>>>(
      (const int32_t*)row_ptr, (const int32_t*)col_idx, (const V*)x, (V*)out,
      n_rows, fv, n_chunks, (const int32_t*)hub_rows, n_hub, hub_min);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// vec: 4 (x and out 16-byte aligned, f % 4 == 0) or 1. hub_rows: n_hub
// device ints, every row of more than hub_min edges (NULL when n_hub is 0).
int vgl_pull_rows_f32(const void* row_ptr, const void* col_idx,
                      const void* x, void* out, int n_rows, int f,
                      const void* hub_rows, int n_hub, int hub_min, int vec,
                      void* stream) {
  if (n_rows < 0 || f < 0 || n_hub < 0 || hub_min < 0 ||
      (n_hub > 0 && hub_rows == nullptr) || (vec != 1 && vec != 4) ||
      f % vec != 0)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0 || f == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (vec == 4)
    return launch<float4>(row_ptr, col_idx, x, out, n_rows, f / 4, hub_rows,
                          n_hub, hub_min, st);
  return launch<float>(row_ptr, col_idx, x, out, n_rows, f, hub_rows, n_hub,
                       hub_min, st);
}

}  // extern "C"
