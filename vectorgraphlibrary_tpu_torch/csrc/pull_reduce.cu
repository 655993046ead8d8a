// pull_reduce: one CSR pull per advance.
//
//   out[v] = op over k in [row_ptr[v], row_ptr[v+1]) of wop(x[col_idx[k]], w[k]),
//            skipping k with exclude_self_loops && col_idx[k] == v
//   out[v] = ident for an empty row                     op in {add, min, max, or}
//
// w (optional, f32 and i32 only) holds one value per edge in CSR slot order and
// wop in {add, min, max, mul} joins it to the source's value: min over x + w is
// the SSSP relaxation, max over min(x, w) the widest-path one. Without w the
// message is x[col_idx[k]] itself.
//
// The segment-reduce entries (vgl_segment_reduce_*) take no col_idx: the
// message of slot k is x[k] itself, one value per CSR slot, so they reduce
// per-edge messages over the sorted segments of row_ptr (the general advance,
// ops/advance.advance_pull, makes the messages with the user's edge op). Same
// ops, types, work units and fixed order; no weights and no self-loop test.
//
// Replaces, on the advance's path, the chain that ran the TPU route kernels of
// vectorgraphlibrary_tpu/ops/pallas/route_fused.py (_mid_kernel, _big_kernel
// and the _finish epilogue, whose port is csrc/route_gather.cu): a vertex
// route, the broadcast of the source vector over the source tiles into one
// message per slot, the slot route with the finish, and the per-destination
// tile reduction. The TPU needed the Beneš network because per-element gathers
// were its slow operation; here that chain computes the formula above over the
// direction's own CSR, which the device graph already holds.
//
// What bounds it on Hopper: memory. Per edge it streams col_idx (4 B,
// coalesced within a row; w[k] beside it, 4 B more, at the same offsets) and
// reads x[col_idx[k]] at random; x is a vertex
// vector (1 MB of f32 at RMAT-18, 1 MB of int8 at RMAT-20) that stays in the
// 50 MB L2, so those reads cost L2 bandwidth, not HBM sectors. No slot-sized
// array is read or written. Rows are in descending degree order, so the
// graph's degree classes give contiguous row ranges of similar width; the
// caller passes them as segments, each with a group of threads per row:
//
//   wide huge rows   one block of kThreads per row (over 2,048 edges),
//                    fixed-shape reduction through shared memory
//   other huge rows  one warp per row, strided lane loop, __shfl_xor_sync
//                    tree
//   bucket rows      1..32 threads per row, the same tree
//
// Each thread makes kUnroll predicated loads of col_idx (and of w), then
// kUnroll of x, all independent: the first version, with one or two loads in flight per
// thread, took 14x its bound, so the kernel is bound by how many loads are in
// flight. A bucket of width w gets w / kUnroll threads per row
// (ops/advance.row_groups), so that a row takes one round trip for each.
//
// Everything runs in one launch: a block finds its segment from the block
// ranges. No atomics: each row is reduced by one group in a fixed order (each
// thread's strided partial, then a fixed tree), so an f32 sum comes out with
// the same bits on every run. min/max propagate NaN as torch.minimum/maximum
// do. 1-byte values compute in int32 and are narrowed on store; integer sums
// wrap as torch's do.
//
// Plain C interface (loaded with ctypes): each entry returns cudaGetLastError()
// after the launch, runs on the given stream and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum Op { OP_ADD = 0, OP_MIN = 1, OP_MAX = 2, OP_OR = 3 };
enum Wop { WOP_ADD = 1, WOP_MIN = 2, WOP_MAX = 3, WOP_MUL = 4 };

constexpr int kThreads = 512;     // block size; also the group of a huge row
constexpr int kMaxSegs = 8;
constexpr int kUnroll = 8;        // loads in flight per thread

// Segment s covers rows [row_end[s-1], row_end[s]) (row_end[-1] = 0) with
// group[s] threads per row, in blocks [block_end[s-1], block_end[s]).
struct Segs {
  int n;
  int row_end[kMaxSegs];
  int group[kMaxSegs];
  int block_end[kMaxSegs];
};

template <typename T> struct Compute { typedef T type; };
template <> struct Compute<int8_t> { typedef int32_t type; };

template <typename C> __device__ __forceinline__ bool is_nan(C) { return false; }
template <> __device__ __forceinline__ bool is_nan<float>(float a) { return a != a; }

template <int OP, typename C>
__device__ __forceinline__ C combine(C a, C b) {
  if constexpr (OP == OP_ADD) {
    if constexpr (std::is_same<C, float>::value) return a + b;
    else return (C)((uint32_t)a + (uint32_t)b);   // wraps, no signed overflow
  } else if constexpr (OP == OP_MIN) {
    return is_nan(a) ? a : (is_nan(b) ? b : (b < a ? b : a));
  } else if constexpr (OP == OP_MAX) {
    return is_nan(a) ? a : (is_nan(b) ? b : (b > a ? b : a));
  } else {
    if constexpr (std::is_same<C, float>::value) return a;  // never launched
    else return a | b;
  }
}

// The message of one edge: the source's value joined to the edge's. wop is the
// same for every thread of a launch, so the switch does not diverge.
template <typename C>
__device__ __forceinline__ C join(int wop, C a, C w) {
  switch (wop) {
    case WOP_ADD: return combine<OP_ADD, C>(a, w);
    case WOP_MIN: return combine<OP_MIN, C>(a, w);
    case WOP_MAX: return combine<OP_MAX, C>(a, w);
    default:
      if constexpr (std::is_same<C, float>::value) return a * w;
      else return (C)((uint32_t)a * (uint32_t)w);   // wraps
  }
}

template <typename T, int OP, bool HAS_W, bool SEG>
__global__ void __launch_bounds__(kThreads)
pull_reduce_kernel(const int32_t* __restrict__ row_ptr,
                   const int32_t* __restrict__ col_idx,
                   const T* __restrict__ x, const T* __restrict__ w, int wop,
                   T* __restrict__ out, Segs segs, int exclude_self_loops,
                   T ident) {
  typedef typename Compute<T>::type C;
  __shared__ C s_warp[kThreads / 32];
  const int b = blockIdx.x;
  int s = 0;
  while (s < segs.n - 1 && b >= segs.block_end[s]) ++s;
  const int row0 = s == 0 ? 0 : segs.row_end[s - 1];
  const int block0 = s == 0 ? 0 : segs.block_end[s - 1];
  const int g = segs.group[s];
  const int tid = threadIdx.x;
  const int row = row0 + (b - block0) * (kThreads / g) + tid / g;
  const int lane = tid & (g - 1);
  const bool live = row < segs.row_end[s];
  const C id = (C)ident;

  C acc = id;
  if (live) {
    const int end = __ldg(row_ptr + row + 1);
    // kUnroll predicated loads per round, all independent: a row of up to
    // kUnroll * g edges takes one round trip for col_idx and one for x
    for (int k = __ldg(row_ptr + row) + lane; k < end; k += kUnroll * g) {
      if constexpr (SEG) {          // the messages are x's slots themselves
        C m[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          m[u] = k + u * g < end ? (C)__ldg(x + k + u * g) : id;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) acc = combine<OP, C>(acc, m[u]);
        continue;
      }
      int c[kUnroll];
      C ew[HAS_W ? kUnroll : 1];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool in = k + u * g < end;
        c[u] = in ? __ldg(col_idx + k + u * g) : -1;
        if constexpr (HAS_W) ew[u] = in ? (C)__ldg(w + k + u * g) : id;
      }
      C v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool keep = !(c[u] < 0 || (exclude_self_loops && c[u] == row));
        v[u] = keep ? (C)__ldg(x + c[u]) : id;
        if constexpr (HAS_W) v[u] = keep ? join<C>(wop, v[u], ew[u]) : id;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc = combine<OP, C>(acc, v[u]);
    }
  }
  // the group's tree: lanes of one group differ only in their low bits
  for (int off = (g < 32 ? g : 32) / 2; off > 0; off >>= 1)
    acc = combine<OP, C>(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (g == kThreads) {          // uniform over the block
    if ((tid & 31) == 0) s_warp[tid >> 5] = acc;
    __syncthreads();
    if (tid < 32) {
      acc = tid < kThreads / 32 ? s_warp[tid] : id;
      for (int off = kThreads / 64; off > 0; off >>= 1)
        acc = combine<OP, C>(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    }
  }
  if (live && lane == 0) out[row] = (T)acc;
}

template <typename T, int OP>
void launch_op(unsigned grid, cudaStream_t st, const int32_t* rp,
               const int32_t* ci, const T* xp, const T* wp, int wop, T* o,
               const Segs& segs, int exclude_self_loops, T ident) {
  if (ci == nullptr) {
    pull_reduce_kernel<T, OP, false, true><<<grid, kThreads, 0, st>>>(
        rp, nullptr, xp, nullptr, 0, o, segs, 0, ident);
    return;
  }
  if constexpr (!std::is_same<T, int8_t>::value) {
    if (wp != nullptr) {
      pull_reduce_kernel<T, OP, true, false><<<grid, kThreads, 0, st>>>(
          rp, ci, xp, wp, wop, o, segs, exclude_self_loops, ident);
      return;
    }
  }
  pull_reduce_kernel<T, OP, false, false><<<grid, kThreads, 0, st>>>(
      rp, ci, xp, nullptr, 0, o, segs, exclude_self_loops, ident);
}

template <typename T>
int launch(const void* row_ptr, const void* col_idx, const void* x,
           const void* w, int wop, void* out, const int* row_end,
           const int* group, int n_segs, int exclude_self_loops, int op,
           T ident, void* stream) {
  if (n_segs < 1 || n_segs > kMaxSegs) return (int)cudaErrorInvalidValue;
  // edge values come with a join op, and not with 1-byte values; the
  // segment reduction (no col_idx) takes neither them nor the self-loop test
  if ((w != nullptr) != (wop != 0) || wop < 0 || wop > WOP_MUL ||
      (w != nullptr && std::is_same<T, int8_t>::value) ||
      (col_idx == nullptr && (w != nullptr || exclude_self_loops)))
    return (int)cudaErrorInvalidValue;
  Segs segs;
  segs.n = n_segs;
  long long blocks = 0;
  int prev = 0;
  for (int s = 0; s < n_segs; ++s) {
    const int g = group[s];
    if (g < 1 || g > kThreads || (g & (g - 1)) != 0 || (g > 32 && g != kThreads)
        || row_end[s] < prev)
      return (int)cudaErrorInvalidValue;
    const int per_block = kThreads / g;
    blocks += ((long long)row_end[s] - prev + per_block - 1) / per_block;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    segs.row_end[s] = row_end[s];
    segs.group[s] = g;
    segs.block_end[s] = (int)blocks;
    prev = row_end[s];
  }
  if (blocks == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* rp = (const int32_t*)row_ptr;
  const int32_t* ci = (const int32_t*)col_idx;
  const T* xp = (const T*)x;
  const T* wp = (const T*)w;
  T* o = (T*)out;
  const unsigned grid = (unsigned)blocks;
  switch (op) {
    case OP_ADD:
      launch_op<T, OP_ADD>(grid, st, rp, ci, xp, wp, wop, o, segs,
                           exclude_self_loops, ident);
      break;
    case OP_MIN:
      launch_op<T, OP_MIN>(grid, st, rp, ci, xp, wp, wop, o, segs,
                           exclude_self_loops, ident);
      break;
    case OP_MAX:
      launch_op<T, OP_MAX>(grid, st, rp, ci, xp, wp, wop, o, segs,
                           exclude_self_loops, ident);
      break;
    case OP_OR:
      if (std::is_same<T, float>::value) return (int)cudaErrorInvalidValue;
      launch_op<T, OP_OR>(grid, st, rp, ci, xp, wp, wop, o, segs,
                          exclude_self_loops, ident);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// row_end/group: n_segs host ints (the segments above); the last row_end is
// the number of rows, and out has that many entries. w: one value of x's type
// per CSR slot with wop in 1..4 (add, min, max, mul), or NULL with wop 0.
int vgl_pull_reduce_f32(const void* row_ptr, const void* col_idx,
                        const void* x, const void* w, int wop, void* out,
                        const int* row_end, const int* group, int n_segs,
                        int exclude_self_loops, int op, float ident,
                        void* stream) {
  return launch<float>(row_ptr, col_idx, x, w, wop, out, row_end, group,
                       n_segs, exclude_self_loops, op, ident, stream);
}

int vgl_pull_reduce_i32(const void* row_ptr, const void* col_idx,
                        const void* x, const void* w, int wop, void* out,
                        const int* row_end, const int* group, int n_segs,
                        int exclude_self_loops, int op, int ident,
                        void* stream) {
  return launch<int32_t>(row_ptr, col_idx, x, w, wop, out, row_end, group,
                         n_segs, exclude_self_loops, op, (int32_t)ident,
                         stream);
}

int vgl_pull_reduce_i8(const void* row_ptr, const void* col_idx,
                       const void* x, const void* w, int wop, void* out,
                       const int* row_end, const int* group, int n_segs,
                       int exclude_self_loops, int op, int ident,
                       void* stream) {
  return launch<int8_t>(row_ptr, col_idx, x, w, wop, out, row_end, group,
                        n_segs, exclude_self_loops, op, (int8_t)ident, stream);
}

// The segment reduction: out[v] = op over k in row v of x[k], x one value per
// CSR slot (as long as the CSR's slots at least).
int vgl_segment_reduce_f32(const void* row_ptr, const void* x, void* out,
                           const int* row_end, const int* group, int n_segs,
                           int op, float ident, void* stream) {
  return launch<float>(row_ptr, nullptr, x, nullptr, 0, out, row_end, group,
                       n_segs, 0, op, ident, stream);
}

int vgl_segment_reduce_i32(const void* row_ptr, const void* x, void* out,
                           const int* row_end, const int* group, int n_segs,
                           int op, int ident, void* stream) {
  return launch<int32_t>(row_ptr, nullptr, x, nullptr, 0, out, row_end, group,
                         n_segs, 0, op, (int32_t)ident, stream);
}

int vgl_segment_reduce_i8(const void* row_ptr, const void* x, void* out,
                          const int* row_end, const int* group, int n_segs,
                          int op, int ident, void* stream) {
  return launch<int8_t>(row_ptr, nullptr, x, nullptr, 0, out, row_end, group,
                        n_segs, 0, op, (int8_t)ident, stream);
}

}  // extern "C"
