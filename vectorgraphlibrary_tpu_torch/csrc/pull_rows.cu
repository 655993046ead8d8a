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
// bytes (0.66 ms at RMAT-20 and F = 256), but each edge reads the whole
// F-wide row of its source, E * F * 4 bytes in all (17.2 GB, 5.13 ms from
// device memory), and x (1.07 GB at F = 256) does not fit the 50 MB L2. What
// sets the pace is where those row reads are served from. The graph's ids are
// sorted by degree (graph/build.py), and RMAT's reads are concentrated on the
// lowest ids: at RMAT-20 the 1,536 lowest column ids take 26.5 % of the
// edges, the 16,384 lowest 58.8 %, the 65,536 lowest 82.3 %.
//
// Design. The first design ran one warp per (row, 128-float chunk),
// row-major, a block of 16 warps per hub row, and read every row through L2
// under the default policy. This one changes where a row is read from and
// who reads it, not the order it is summed in:
//
// - Feature chunks, chunk-major. A chunk is cv lanes of VEC floats (VEC =
//   4 where F and x's alignment allow, else 2 or 1; cv <= 32, the F / VEC
//   vectors cut into equal chunks: F = 100 is one chunk of 25 lanes, F =
//   256 two of 32). The grid is n_chunks x n_blocks blocks, chunk-major,
//   n_blocks = the card's SMs (one 1,024-thread block per SM): chunk c is
//   one wave of blocks over the whole CSR, so at any moment only x's
//   current chunk of the hot rows has to stay on chip.
// - Hot rows kept in L2, by column id (the ids are sorted by degree, so
//   the lowest are the hottest): rows below l2_rows = 65,536 (82 % of the
//   edges) are read with L2's evict_last policy (createpolicy +
//   ld.global.nc.L2::cache_hint), the rest with evict_first, so that the
//   cold rows, col_idx (read with __ldcs) and out (written with __stcs)
//   stream past the hot ones. The split gains 5 % against evict_last for
//   every row and 23 % to 26 % against evict_first for every row; a
//   boundary of 32,768 or 131,072 loses 2 % to 3 %. No stream attribute or L2 set-aside is used or left
//   behind. A shared-memory tier of the hottest rows was tried and not
//   kept: its gain was within the spread between two calls, since the
//   tile comes out of the SM's L1, which already holds the often-read
//   rows, and a full 227 KB tile lost.
// - Balanced work, no stragglers. The wrapper's RowCSR splits the rows once
//   per CSR (ops/cuda/pull_rows.schedule): the rows of more than hub_min
//   edges go whole to blocks, largest first onto the least loaded; the
//   other rows are cut into one contiguous range per warp, balanced by
//   edges + 1 per row with each block's hub edges counted against it, and
//   each range into hub-free parts. A warp walks its part's edges in
//   batches of 32 columns (one coalesced load) across row boundaries, with
//   kUnroll rows' loads in flight per lane and the row ends from a window of
//   32 row_ptr entries: a row of two edges does not cost the warp three
//   dependent loads of its own. kUnroll is as large as 64 registers a
//   thread (1,024 threads on an SM) hold without spilling: 6 float4, 10
//   float2, 16 floats. 8 float4 with 64-bit row offsets spilled to the
//   stack and ran far slower than the first design. A hub row's 32-edge batches go round robin
//   to the block's 32 warps, whose partial sums meet in shared memory.
// - The chunk width is a trade. Narrower chunks lose: each (edge, chunk)
//   costs a shuffle, an address, a load and 4 x VEC additions whatever VEC
//   is, so VEC = 2 and 1 (more chunks, the same bytes) take 1.5x to 1.6x
//   and 2.2x to 2.4x as long. A wider one (all 256 floats of F = 256 in one chunk, two
//   float4 a lane) was tried and lost: the 65,536 hottest rows' chunks then
//   take 67 MB against a 50 MB L2; at 128 floats they take 33.5 MB.
//
// Measured (apps/exp_pull_rows.py [--sweep], RMAT-20, H100 80GB HBM3 at
// 700 W, beside the first design in the same run): F = 100 1.40 ms (first
// design 1.52), F = 256 2.81 (3.45), its backward over the transposed CSR
// 2.81 (3.62); torch.sparse.mm 1.66, 3.52, 3.57. The kernel sits at 5.2x
// (F = 100) and 4.2x (F = 256) its bytes bound. 17.2 GB of row reads in
// 2.81 ms is 6.1 TB/s, so at least half of them come from L2 and L1 (device
// memory alone would need 5.13 ms); time per (edge, chunk) hardly changes
// between 400 and 512 bytes a row, so the rate of row requests the SMs get
// served, not device memory, sets the pace.
//
// Sum order, kept from the first design: no atomics. Each output element of
// a non-hub row is one compensated (Kahan) sum in edge order, whatever the
// chunking, VEC or L2 policy, so it equals a sequential f32 Kahan sum
// bit for bit and the first design on those rows; a hub row is 32 warps'
// Kahan sums (warp w takes batches w, w + 32, ...) merged in warp order,
// compensation included (the first design had 16 warps, so hub rows' last
// bits differ from it). Two runs give the same bits.
//
// Shared memory: the hub merge's 32 x 32 partial sums with their
// compensations (8 KB x VEC, static).
//
// Plain C interface (loaded with ctypes): the entry returns
// cudaGetLastError() after the launch (a launch the card refuses shows
// there), runs on the given stream and allocates nothing.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float zero_of(float) { return 0.f; }
__device__ __forceinline__ float2 zero_of(float2) {
  return make_float2(0.f, 0.f);
}
__device__ __forceinline__ float4 zero_of(float4) {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// Row reads under an L2 cache policy (pol from createpolicy), through the
// non-coherent path: x is read-only for the kernel's life.
__device__ __forceinline__ float ld_hint(const float* p, uint64_t pol) {
  float v;
  asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;"
      : "=f"(v) : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ float2 ld_hint(const float2* p, uint64_t pol) {
  float2 v;
  asm("ld.global.nc.L2::cache_hint.v2.f32 {%0, %1}, [%2], %3;"
      : "=f"(v.x), "=f"(v.y) : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ float4 ld_hint(const float4* p, uint64_t pol) {
  float4 v;
  asm("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ uint64_t policy_evict_last() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t policy_evict_first() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
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
__device__ __forceinline__ void add_to(Sum<float2>& a, float2 y) {
  kahan(a.s.x, a.c.x, y.x);
  kahan(a.s.y, a.c.y, y.y);
}
__device__ __forceinline__ void add_to(Sum<float4>& a, float4 y) {
  kahan(a.s.x, a.c.x, y.x);
  kahan(a.s.y, a.c.y, y.y);
  kahan(a.s.z, a.c.z, y.z);
  kahan(a.s.w, a.c.w, y.w);
}
__device__ __forceinline__ float neg(float y) { return -y; }
__device__ __forceinline__ float2 neg(float2 y) {
  return make_float2(-y.x, -y.y);
}
__device__ __forceinline__ float4 neg(float4 y) {
  return make_float4(-y.x, -y.y, -y.z, -y.w);
}
// Adds the compensated sum b (its value is b.s - b.c) to a.
template <typename V>
__device__ __forceinline__ void merge(Sum<V>& a, const Sum<V>& b) {
  add_to(a, b.s);
  add_to(a, neg(b.c));
}
template <typename V> __device__ __forceinline__ Sum<V> zero_sum() {
  return Sum<V>{zero_of(V()), zero_of(V())};
}

// One lane's view of x's chunk: row `col`'s vector f (this lane's), under
// L2's evict_last below l2_rows and evict_first from there on. Every lane of
// a warp calls it with the same col. A row's offset is 32-bit (x holds
// fewer than 2^32 vectors): one register per load in flight, where a 64-bit
// offset took two and made ptxas spill.
template <typename V> struct Rows {
  const V* __restrict__ xf;          // x + f
  unsigned fv;
  int f, lane, l2_rows;              // f: this lane's vector of the row
  uint64_t pol_hot, pol_cold;
  __device__ __forceinline__ V load(int col) const {
    return ld_hint(xf + (unsigned)col * fv,
                   col < l2_rows ? pol_hot : pol_cold);
  }
  // this lane's vector of out's row r
  __device__ __forceinline__ void store(V* out, int r, V v) const {
    __stcs(out + (size_t)r * fv + f, v);
  }
};

// The sum over the 32-edge batches at k, k + stride, ... below end of this
// lane's vector of x[col_idx[.]], in edge order (has_f: the lane holds a
// vector of the chunk). Every lane of the warp calls it with the same k, end
// and stride.
template <typename V, int kUnroll>
__device__ __forceinline__ Sum<V> sum_batches(
    const int32_t* __restrict__ col_idx, const Rows<V>& X, bool has_f, int k,
    int end, int stride) {
  Sum<V> acc = zero_sum<V>();
  for (; k < end; k += stride) {
    const int nb = min(32, end - k);
    const int c = X.lane < nb ? __ldcs(col_idx + k + X.lane) : 0;
    for (int j = 0; j < nb; j += kUnroll) {
      V v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int cu = __shfl_sync(kFull, c, j + u);
        v[u] = (j + u < nb && has_f) ? X.load(cu) : zero_of(V());
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (j + u < nb) add_to(acc, v[u]);
    }
  }
  return acc;
}

// One warp's part: rows [r0, r1), none of them a hub row. The warp walks the
// part's edges in batches of 32 columns across row boundaries and writes
// each row's sum when the walk passes its end (an empty row gets zeros).
// row_end holds row_ptr[rb + 1 + lane], the ends of the 32 rows from rb.
template <typename V, int kUnroll>
__device__ __forceinline__ void walk_rows(
    const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ col_idx,
    const Rows<V>& X, V* __restrict__ out, bool has_f, int r0, int r1) {
  const int lane = X.lane;
  int k = __ldg(row_ptr + r0);
  const int e1 = __ldg(row_ptr + r1);
  int rb = r0;
  int row_end = rb + 1 + lane <= r1 ? __ldg(row_ptr + rb + 1 + lane) : INT_MAX;
  int r = r0;
  int re = __shfl_sync(kFull, row_end, 0);
  Sum<V> acc = zero_sum<V>();
  for (; k < e1; k += 32) {
    const int nb = min(32, e1 - k);
    const int c = lane < nb ? __ldcs(col_idx + k + lane) : 0;
    for (int j = 0; j < nb; j += kUnroll) {
      V v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int cu = __shfl_sync(kFull, c, j + u);
        v[u] = (j + u < nb && has_f) ? X.load(cu) : zero_of(V());
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j + u >= nb) break;
        // rows that end at or before this edge are complete (uniform)
        while (k + j + u >= re) {
          if (has_f) X.store(out, r, acc.s);
          acc = zero_sum<V>();
          ++r;
          if (r - rb == 32) {
            rb = r;
            row_end = rb + 1 + lane <= r1 ? __ldg(row_ptr + rb + 1 + lane)
                                          : INT_MAX;
          }
          re = __shfl_sync(kFull, row_end, r - rb);
        }
        add_to(acc, v[u]);
      }
    }
  }
  // the last row with edges and the empty rows after it
  for (; r < r1; ++r) {
    if (has_f) X.store(out, r, acc.s);
    acc = zero_sum<V>();
  }
}

// Block b takes chunk b / n_blocks and the work of part p = b % n_blocks:
// its hub rows (hub_rows[blk_hub[p]:blk_hub[p+1]]), then per warp w the
// hub-free row ranges parts[warp_part[q]:warp_part[q+1]], q = p * 32 + w.
template <typename V, int kUnroll>
__global__ void __launch_bounds__(kThreads, 1)
pull_rows_kernel(const int32_t* __restrict__ row_ptr,
                 const int32_t* __restrict__ col_idx,
                 const V* __restrict__ x, V* __restrict__ out, int fv, int cv,
                 int l2_rows, int n_blocks,
                 const int32_t* __restrict__ hub_rows,
                 const int32_t* __restrict__ blk_hub,
                 const int32_t* __restrict__ warp_part,
                 const int2* __restrict__ parts) {
  __shared__ Sum<V> s_part[kWarps * 32];
  const int chunk = blockIdx.x / n_blocks;
  const int p = blockIdx.x - chunk * n_blocks;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int f = chunk * cv + lane;
  const bool has_f = lane < cv && f < fv;
  const uint64_t pol_hot = policy_evict_last();
  const uint64_t pol_cold = policy_evict_first();
  const Rows<V> X{x + f, (unsigned)fv, f, lane, l2_rows, pol_hot, pol_cold};

  for (int h = __ldg(blk_hub + p); h < __ldg(blk_hub + p + 1); ++h) {
    const int row = __ldg(hub_rows + h);
    const int start = __ldg(row_ptr + row), end = __ldg(row_ptr + row + 1);
    s_part[warp * 32 + lane] = sum_batches<V, kUnroll>(
        col_idx, X, has_f, start + warp * 32, end, 32 * kWarps);
    __syncthreads();
    if (warp == 0 && has_f) {
      Sum<V> t = s_part[lane];
#pragma unroll 4
      for (int w = 1; w < kWarps; ++w) merge(t, s_part[w * 32 + lane]);
      X.store(out, row, t.s);
    }
    __syncthreads();
  }

  const int q = p * kWarps + warp;
  for (int i = __ldg(warp_part + q); i < __ldg(warp_part + q + 1); ++i) {
    const int2 pr = parts[i];
    walk_rows<V, kUnroll>(row_ptr, col_idx, X, out, has_f, pr.x, pr.y);
  }
}

struct Args {
  const void *row_ptr, *col_idx, *x;
  void* out;
  int fv, l2_rows, n_blocks;
  const void *hub_rows, *blk_hub, *warp_part, *parts;
};

template <typename V, int kUnroll>
int launch(const Args& a, cudaStream_t st) {
  const int n_chunks = (a.fv + 31) / 32;
  const int cv = (a.fv + n_chunks - 1) / n_chunks;
  const long long blocks = (long long)n_chunks * a.n_blocks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  pull_rows_kernel<V, kUnroll><<<(unsigned)blocks, kThreads, 0, st>>>(
      (const int32_t*)a.row_ptr, (const int32_t*)a.col_idx, (const V*)a.x,
      (V*)a.out, a.fv, cv, a.l2_rows, a.n_blocks,
      (const int32_t*)a.hub_rows, (const int32_t*)a.blk_hub,
      (const int32_t*)a.warp_part, (const int2*)a.parts);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// vec: 4, 2 or 1 (x and out aligned to vec floats, f % vec == 0; refused
// otherwise); x holds fewer than 2^32 vectors of vec floats (the wrapper
// checks). Columns below l2_rows are read with L2's evict_last, the
// others with evict_first. The schedule
// (ops/cuda/pull_rows.schedule for n_blocks blocks of 32 warps): hub_rows
// grouped by block, blk_hub [n_blocks + 1], warp_part [n_blocks * 32 + 1]
// into parts, int32 pairs [r0, r1).
int vgl_pull_rows_f32(const void* row_ptr, const void* col_idx,
                      const void* x, void* out, int n_rows, int f, int vec,
                      int l2_rows, int n_blocks,
                      const void* hub_rows, const void* blk_hub,
                      const void* warp_part, const void* parts,
                      void* stream) {
  if (n_rows < 0 || f < 0 || n_blocks <= 0 ||
      (vec != 1 && vec != 2 && vec != 4) || f % vec != 0 ||
      ((uintptr_t)x | (uintptr_t)out) % (4u * vec) != 0 ||
      blk_hub == nullptr || warp_part == nullptr)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0 || f == 0) return (int)cudaGetLastError();
  const Args a{row_ptr, col_idx, x, out, f / vec, l2_rows, n_blocks,
               hub_rows, blk_hub, warp_part, parts};
  cudaStream_t st = (cudaStream_t)stream;
  if (vec == 4) return launch<float4, 6>(a, st);
  if (vec == 2) return launch<float2, 10>(a, st);
  return launch<float, 16>(a, st);
}

}  // extern "C"
