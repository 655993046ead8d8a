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
// ops, types, schedule and fixed order; no weights and no self-loop test.
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
// What bounds it on Hopper: the gathers of x. Per edge it reads col_idx
// (4 B; w[k] beside it, 4 B more) once and x[col_idx[k]] at random; x is a
// vertex vector (4 MB of f32 at RMAT-20) that L1 and the 50 MB L2 serve, and
// how many of those reads L1 serves sets the pace: the bytes bound is 0.0238
// ms at RMAT-20, the kernel takes about 0.08. So nothing per slot goes
// through shared memory (it would take its room from L1: designs that staged
// the messages there were slower the more shared memory they held), x is
// read through L1 under L2's evict_last policy, and row_ptr under
// evict_first past L1. A 4-byte x too large for L1 to keep its hot part
// (over 2 MB: 4 MB at RMAT-20, 1 MB at RMAT-18) reads only its first
// columns through L1 (COLD, hot: the graph's highest-degree vertices come
// first) and the rest past it, so that those stay.
//
// The schedule balances edges and rows together (merge path, as in Merrill
// and Garland's CSR SpMV): the n row ends and the e slots of the CSR form one
// sorted sequence of n + e items (row v's end comes after its last slot), and
// block b takes items [b * kTile, (b + 1) * kTile). Its start (row, slot)
// comes from the plan (ops/cuda/pull_reduce.make_plan: one search over
// row_ptr, made once per CSR and kept), so an empty row costs one item and a
// hub row spreads over as many blocks as its slots fill. A block:
//
//   1. reads its tile's row ends, lane-contiguous, into shared memory (2 B
//      each: tile-local slots);
//   2. gives each thread kItems consecutive items, found by a merge-path
//      search over them at both ends;
//   3. reads the thread's slots' columns (and w), then gathers x for them:
//      kItems loads of each in flight, all before the first use;
//   4. walks the items in order in registers: a slot folds the first
//      message in and shifts the rest down, a row end writes the row (the
//      thread's first row end waits for step 5);
//   5. combines the threads' open rows by a segmented scan over the block in
//      a fixed tree (shuffles, then one pass over the warps), which gives each
//      thread the value its first row carries in from earlier threads;
//   6. leaves, for a row cut by its tile's boundaries, the tile's tail value
//      and the head value in a carry array; a second, small launch
//      (pull_reduce_fixup_kernel, a warp per row) combines each such row's
//      carries in tile order. No atomics: every row is reduced in one fixed
//      order, so an f32 sum has the same bits on every run.
//
// kItems = 5 and 8 blocks of 256 threads an SM (at most 32 registers a
// thread, no spill; 2,660 B of shared memory a block) were the fastest of
// the shapes tried on RMAT-18 and RMAT-20 (2 to 16 items, 128 to 512
// threads). On an H100 80GB HBM3 at 700 W, f32 add took 0.0379 ms on
// RMAT-18 without self-loops and 0.0839 on RMAT-20 against 0.0564 and
// 0.1279 for torch.mv (chip_smoke.py, CUDA events, both kernels and the gap
// between them); by device time in one run (apps/exp_pull.py), 0.0337 and
// 0.0793 against 0.0546 and 0.1642 for the degree-class schedule before it.
//
// f32 min/max follow the port's one rule (f32_minmax.cuh: NaN propagates,
// -0.0 below +0.0, the same bits in any order). 1-byte values compute in
// int32 and are narrowed on store; integer sums wrap as torch's do.
//
// Plain C interface (loaded with ctypes): each entry returns cudaGetLastError()
// after its launches, runs on the given stream and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "f32_minmax.cuh"

namespace {

enum Op { OP_ADD = 0, OP_MIN = 1, OP_MAX = 2, OP_OR = 3 };
enum Wop { WOP_ADD = 1, WOP_MIN = 2, WOP_MAX = 3, WOP_MUL = 4 };
// what a slot's message is: x[col_idx[k]], joined to w[k], or x[k]
enum Mode { GATHER = 0, WEIGHTED = 1, SEGMENT = 2 };

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 5;                   // merge items per thread
constexpr int kTile = kThreads * kItems;    // merge items per block
constexpr int kFixThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

template <typename T> struct Compute { typedef T type; };
template <> struct Compute<int8_t> { typedef int32_t type; };

template <int OP, typename C>
__device__ __forceinline__ C combine(C a, C b) {
  if constexpr (OP == OP_ADD) {
    if constexpr (std::is_same<C, float>::value) return a + b;
    else return (C)((uint32_t)a + (uint32_t)b);   // wraps, no signed overflow
  } else if constexpr (OP == OP_MIN) {
    if constexpr (std::is_same<C, float>::value) return vgl_fmin(a, b);
    else return b < a ? b : a;
  } else if constexpr (OP == OP_MAX) {
    if constexpr (std::is_same<C, float>::value) return vgl_fmax(a, b);
    else return b > a ? b : a;
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

// 4-byte reads through the non-coherent path (nothing the kernel reads is
// written during its life) under an L2 cache policy: ld_stream skips L1 (a
// warp's coalesced read of row_ptr, x's cold columns), ld_keep allocates in
// it.
__device__ __forceinline__ int32_t ld_stream(const void* p, uint64_t pol) {
  int32_t v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.b32 %0, [%1], %2;"
      : "=r"(v) : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ int32_t ld_keep(const void* p, uint64_t pol) {
  int32_t v;
  asm("ld.global.nc.L2::cache_hint.b32 %0, [%1], %2;"
      : "=r"(v) : "l"(p), "l"(pol));
  return v;
}
template <typename C> __device__ __forceinline__ C as(int32_t v) { return v; }
template <> __device__ __forceinline__ float as<float>(int32_t v) {
  return __int_as_float(v);
}
// One value of x, w or col_idx: 4-byte types under pol, bytes plainly.
// Through L1 in either case: x's hot lines stay there, and a lane's slots
// are consecutive, so the lines a warp's strided read of one step brings
// in serve its next steps.
template <typename T>
__device__ __forceinline__ typename Compute<T>::type load(const T* p,
                                                         uint64_t pol) {
  if constexpr (sizeof(T) == 1) return __ldg(p);
  else return as<typename Compute<T>::type>(ld_keep(p, pol));
}
// x[c] (4-byte) for a column past the hot ones: it skips L1, so that the
// hot lines stay there
template <typename T>
__device__ __forceinline__ T load_cold(const T* p, uint64_t pol) {
  return as<T>(ld_stream(p, pol));
}

// s_end's entry for the row open at the tile's end: past every slot
constexpr uint16_t kOpenRow = 0xffff;

// How many of the tile's rows end within its first d items: the i with
// s_end[i] + i + 1 <= d, searched in [max(0, d - ns), min(d, a_len)].
__device__ __forceinline__ int rows_before(const uint16_t* s_end, int d,
                                           int ns, int a_len) {
  int lo = max(0, d - ns), hi = min(d, a_len);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_end[mid] + mid + 1 <= d) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Block b's tile is merge items [b * kTile, (b + 1) * kTile): rows
// [tiles[b].x, tiles[b + 1].x) end in it and it holds slots [tiles[b].y,
// tiles[b + 1].y). carry (or null when no row crosses a tile boundary) gets
// each tile's tail value at [b] and its head value at [n_tiles + b].
template <typename T, int OP, int MODE, bool EXCL, bool COLD>
__global__ void __launch_bounds__(kThreads, 8)
pull_reduce_kernel(const int32_t* __restrict__ row_ptr,
            const int32_t* __restrict__ col_idx, const T* __restrict__ x,
            const T* __restrict__ w, int wop, int hot,
            T* __restrict__ out, const int2* __restrict__ tiles,
            typename Compute<T>::type* __restrict__ carry, int n_tiles,
            T ident) {
  typedef typename Compute<T>::type C;
  // row ends as tile-local slots (at most kTile): the tile's only shared
  // array, so that L1 keeps nearly all of its 256 KB for x
  __shared__ uint16_t s_end[kTile + 1];
  __shared__ int s_wkey[kWarps];
  __shared__ C s_wval[kWarps];
  __shared__ C s_wcarry[kWarps];

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int2 lo = tiles[b];
  const int2 hi = tiles[b + 1];
  const int r0 = lo.x, k0 = lo.y;
  const int a_len = hi.x - r0;              // rows that end in the tile
  const int ns = hi.y - k0;                 // slots in the tile
  const int items = a_len + ns;
  const C id = (C)ident;

  // 1. the tile's row ends, read lane-contiguous
  const uint64_t pol_stream = policy_evict_first();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = t + j * kThreads;
    if (i < a_len)
      s_end[i] = (uint16_t)(ld_stream(row_ptr + r0 + i + 1, pol_stream) - k0);
  }
  if (t == 0) s_end[a_len] = kOpenRow;      // the row open at the tile's end
  __syncthreads();

  // 2. the thread's items [d0, d1): after d items of the tile, rows i end
  // where s_end[i] + i + 1 <= d, and d minus their count slots are taken
  const int d0 = min(t * kItems, items);
  const int d1 = min(d0 + kItems, items);
  const int i0 = rows_before(s_end, d0, ns, a_len);
  const int ks = d0 - i0;                   // the thread's first slot
  const int n = d1 - rows_before(s_end, d1, ns, a_len) - ks;

  // 3. its slots' columns (and w), then x, every load in flight before the
  // first use; without col_idx a slot's message is x[k] itself
  C m[kItems];
  int c[kItems];
  if constexpr (MODE == SEGMENT) {
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      m[j] = j < n ? load(x + k0 + ks + j, pol_stream) : id;
  } else {
    C ew[MODE == WEIGHTED ? kItems : 1];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      c[j] = j < n ? load(col_idx + k0 + ks + j, pol_stream) : -1;
      if constexpr (MODE == WEIGHTED)
        ew[j] = j < n ? load(w + k0 + ks + j, pol_stream) : id;
    }
    const uint64_t pol_keep = policy_evict_last();
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if constexpr (COLD)
        m[j] = j < n ? (c[j] < hot ? load(x + c[j], pol_keep)
                                   : load_cold(x + c[j], pol_keep))
                     : id;
      else
        m[j] = j < n ? load(x + c[j], pol_keep) : id;
      if constexpr (MODE == WEIGHTED) m[j] = join<C>(wop, m[j], ew[j]);
    }
  }

  // 4. the walk: a row end writes the row (the thread's first waits for
  // step 5), a slot folds m[0] in and the registers shift down by one
  int i = i0, k = ks;
  C acc = id, first_acc = id;
  int first = -1;
#pragma unroll
  for (int s = 0; s < kItems; ++s) {
    if (d0 + s < d1) {
      if (s_end[i] <= k) {                  // row r0 + i ends
        if (first < 0) {
          first = i;
          first_acc = acc;
        } else {
          out[r0 + i] = (T)acc;
        }
        acc = id;
        ++i;
      } else {
        C v = m[0];
        if constexpr (EXCL) {
          if (c[0] == r0 + i) v = id;
        }
        acc = combine<OP, C>(acc, v);
        ++k;
#pragma unroll
        for (int j = 0; j + 1 < kItems; ++j) {
          m[j] = m[j + 1];
          if constexpr (EXCL) c[j] = c[j + 1];
        }
      }
    }
  }

  // 5. segmented inclusive scan of the threads' open rows (key i, value acc):
  // keys never decrease from thread to thread, and thread t's first row is
  // thread t - 1's open row
  const int lane = t & 31, wid = t >> 5;
  C val = acc;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int ko = __shfl_up_sync(kFull, i, o);
    const C vo = __shfl_up_sync(kFull, val, o);
    if (lane >= o && ko == i) val = combine<OP, C>(vo, val);
  }
  if (lane == 31) {
    s_wkey[wid] = i;
    s_wval[wid] = val;
  }
  __syncthreads();
  if (t == 0) {
    C run = s_wval[0];
    for (int q = 1; q < kWarps; ++q) {
      s_wcarry[q] = run;                    // the block's value at warp q - 1's end
      run = s_wkey[q] == s_wkey[q - 1] ? combine<OP, C>(run, s_wval[q])
                                        : s_wval[q];
    }
  }
  __syncthreads();
  const C win = wid > 0 ? s_wcarry[wid] : id;
  const C bval = wid > 0 && i == s_wkey[wid - 1] ? combine<OP, C>(win, val)
                                                 : val;
  C cin = __shfl_up_sync(kFull, bval, 1);
  if (lane == 0) cin = win;
  if (first >= 0) {
    const C v = combine<OP, C>(cin, first_acc);
    // a row that began in an earlier tile: its head value waits for the fixup
    if (first == 0 && __ldg(row_ptr + r0) < k0) carry[n_tiles + b] = v;
    else out[r0 + first] = (T)v;
  }
  // 6. the tile's tail value: the thread that holds the tile's last item
  if (carry != nullptr && d0 < items && d1 == items) carry[b] = bval;
}

// fix[f] = (tile b, tile bs): the row that ends in tile b began in tile bs <
// b; its value is the tails of tiles bs .. b - 1, then b's head. A warp per
// row: lane l folds tails bs + l, bs + l + 32, ... in order, a fixed tree
// joins the lanes, then the head comes last.
template <typename T, int OP>
__global__ void __launch_bounds__(kFixThreads)
pull_reduce_fixup_kernel(const int2* __restrict__ tiles,
                         const int2* __restrict__ fix, int n_fix,
                         const typename Compute<T>::type* __restrict__ carry,
                         int n_tiles, T* __restrict__ out, T ident) {
  typedef typename Compute<T>::type C;
  const int f = (blockIdx.x * kFixThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (f >= n_fix) return;                   // the whole warp
  const int2 e = fix[f];
  C acc = (C)ident;
  for (int q = e.y + lane; q < e.x; q += 32)
    acc = combine<OP, C>(acc, carry[q]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc = combine<OP, C>(acc, __shfl_down_sync(kFull, acc, o));
  if (lane == 0)
    out[tiles[e.x].x] = (T)combine<OP, C>(acc, carry[n_tiles + e.x]);
}

struct Args {
  const int32_t* row_ptr;
  const int32_t* col_idx;
  const void* x;
  const void* w;
  int wop;
  int hot;                      // columns below it read x through L1; < 0: all
  void* out;
  const int2* tiles;
  int n_tiles;
  const int2* fix;
  int n_fix;
  void* carry;
  int exclude_self_loops;
  bool segment;                 // the segment-reduce entries: no col_idx
};

template <typename T, int OP, int MODE, bool EXCL, bool COLD = false>
void launch_kernels(const Args& a, T ident, cudaStream_t st) {
  typedef typename Compute<T>::type C;
  pull_reduce_kernel<T, OP, MODE, EXCL, COLD><<<a.n_tiles, kThreads, 0, st>>>(
      a.row_ptr, a.col_idx, (const T*)a.x, (const T*)a.w, a.wop, a.hot,
      (T*)a.out,
      a.tiles, (C*)a.carry, a.n_tiles, ident);
  constexpr int rows_per_block = kFixThreads / 32;
  if (a.n_fix > 0)
    pull_reduce_fixup_kernel<T, OP>
        <<<(a.n_fix + rows_per_block - 1) / rows_per_block, kFixThreads, 0,
           st>>>(a.tiles, a.fix, a.n_fix, (const C*)a.carry, a.n_tiles,
                 (T*)a.out, ident);
}

// The gathering modes: with or without the self-loop test, and for a
// 4-byte x with a hot bound (a byte's x reads through L1 either way)
template <typename T, int OP, int MODE>
void launch_gather(const Args& a, T ident, cudaStream_t st) {
  if constexpr (sizeof(T) == 4) {
    if (a.hot >= 0) {
      if (a.exclude_self_loops) launch_kernels<T, OP, MODE, true, true>(a, ident, st);
      else launch_kernels<T, OP, MODE, false, true>(a, ident, st);
      return;
    }
  }
  if (a.exclude_self_loops) launch_kernels<T, OP, MODE, true>(a, ident, st);
  else launch_kernels<T, OP, MODE, false>(a, ident, st);
}

template <typename T, int OP>
void launch_op(const Args& a, T ident, cudaStream_t st) {
  if (a.segment) {
    launch_kernels<T, OP, SEGMENT, false>(a, ident, st);
    return;
  }
  if constexpr (!std::is_same<T, int8_t>::value) {
    if (a.wop != 0) {
      launch_gather<T, OP, WEIGHTED>(a, ident, st);
      return;
    }
  }
  launch_gather<T, OP, GATHER>(a, ident, st);
}

template <typename T>
int launch(const Args& a, int op, T ident, void* stream) {
  // edge values (wop != 0; w may be NULL only when there is no slot) come
  // not with 1-byte values; the segment reduction takes neither them nor
  // the self-loop test
  if (a.wop < 0 || a.wop > WOP_MUL ||
      (a.wop != 0 && std::is_same<T, int8_t>::value) ||
      (a.segment && (a.wop != 0 || a.exclude_self_loops)) ||
      a.n_tiles < 0 || a.n_fix < 0 || (a.n_fix > 0 && a.carry == nullptr))
    return (int)cudaErrorInvalidValue;
  if (a.n_tiles == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  switch (op) {
    case OP_ADD: launch_op<T, OP_ADD>(a, ident, st); break;
    case OP_MIN: launch_op<T, OP_MIN>(a, ident, st); break;
    case OP_MAX: launch_op<T, OP_MAX>(a, ident, st); break;
    case OP_OR:
      if (std::is_same<T, float>::value) return (int)cudaErrorInvalidValue;
      launch_op<T, OP_OR>(a, ident, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// tiles: int32 [n_tiles + 1, 2], fix: int32 [n_fix, 2], the plan of row_ptr
// (ops/cuda/pull_reduce.make_plan); carry: 2 * n_tiles 4-byte values of
// scratch, or NULL when n_fix is 0. out has row_ptr's n entries. w: one value
// of x's type per CSR slot with wop in 1..4 (add, min, max, mul), or wop 0
// for none. hot: x[c] with c < hot is read through L1, the rest past it
// (4-byte types; every x[c] through L1 when hot < 0).
int vgl_pull_reduce_f32(const void* row_ptr, const void* col_idx,
                        const void* x, const void* w, int wop, int hot,
                        void* out, const void* tiles, int n_tiles,
                        const void* fix, int n_fix, void* carry,
                        int exclude_self_loops, int op,
                        float ident, void* stream) {
  const Args a{(const int32_t*)row_ptr, (const int32_t*)col_idx, x, w, wop,
               hot, out, (const int2*)tiles, n_tiles, (const int2*)fix,
               n_fix, carry, exclude_self_loops, false};
  return launch<float>(a, op, ident, stream);
}

int vgl_pull_reduce_i32(const void* row_ptr, const void* col_idx,
                        const void* x, const void* w, int wop, int hot,
                        void* out, const void* tiles, int n_tiles,
                        const void* fix, int n_fix, void* carry,
                        int exclude_self_loops, int op,
                        int ident, void* stream) {
  const Args a{(const int32_t*)row_ptr, (const int32_t*)col_idx, x, w, wop,
               hot, out, (const int2*)tiles, n_tiles, (const int2*)fix,
               n_fix, carry, exclude_self_loops, false};
  return launch<int32_t>(a, op, (int32_t)ident, stream);
}

int vgl_pull_reduce_i8(const void* row_ptr, const void* col_idx,
                       const void* x, const void* w, int wop, int hot,
                       void* out, const void* tiles, int n_tiles,
                       const void* fix, int n_fix, void* carry,
                       int exclude_self_loops, int op,
                       int ident, void* stream) {
  const Args a{(const int32_t*)row_ptr, (const int32_t*)col_idx, x, w, wop,
               hot, out, (const int2*)tiles, n_tiles, (const int2*)fix,
               n_fix, carry, exclude_self_loops, false};
  return launch<int8_t>(a, op, (int8_t)ident, stream);
}

// The segment reduction: out[v] = op over k in row v of x[k], x one value per
// CSR slot (as long as the CSR's slots at least).
int vgl_segment_reduce_f32(const void* row_ptr, const void* x, void* out,
                           const void* tiles, int n_tiles, const void* fix,
                           int n_fix, void* carry, int op, float ident,
                           void* stream) {
  const Args a{(const int32_t*)row_ptr, nullptr, x, nullptr, 0, 0, out,
               (const int2*)tiles, n_tiles, (const int2*)fix, n_fix, carry, 0,
               true};
  return launch<float>(a, op, ident, stream);
}

int vgl_segment_reduce_i32(const void* row_ptr, const void* x, void* out,
                           const void* tiles, int n_tiles, const void* fix,
                           int n_fix, void* carry, int op, int ident,
                           void* stream) {
  const Args a{(const int32_t*)row_ptr, nullptr, x, nullptr, 0, 0, out,
               (const int2*)tiles, n_tiles, (const int2*)fix, n_fix, carry, 0,
               true};
  return launch<int32_t>(a, op, (int32_t)ident, stream);
}

int vgl_segment_reduce_i8(const void* row_ptr, const void* x, void* out,
                          const void* tiles, int n_tiles, const void* fix,
                          int n_fix, void* carry, int op, int ident,
                          void* stream) {
  const Args a{(const int32_t*)row_ptr, nullptr, x, nullptr, 0, 0, out,
               (const int2*)tiles, n_tiles, (const int2*)fix, n_fix, carry, 0,
               true};
  return launch<int8_t>(a, op, (int8_t)ident, stream);
}

}  // extern "C"
