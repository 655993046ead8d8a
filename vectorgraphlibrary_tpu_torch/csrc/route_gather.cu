// route_gather_finish: one static slot route, with the fused advance finish.
//
//   out[i] = keep(i) ? wop(x[idx[i]], w[i]) : ident
//   keep(i) = flags == NULL
//             || ((flags[i] & 1) && !(exclude_self_loops && (flags[i] & 2)))
//
// Replaces the TPU route kernels of vectorgraphlibrary_tpu/ops/pallas/route_fused.py:
// the composite _big_kernel (in-half) -> _mid_kernel -> _big_kernel (out-half),
// launched by _big_call/_one_big and _mid_call from apply_route_fused, in both
// directions, including the outer/inner split path (_split_kq, _big_pairs), and
// the finish epilogue (_finish). Composed, those kernels compute a fixed
// permutation of 128-lane rows through 2*(log2 n - 7) masked exchange stages and
// a lane shuffle; here the permutation is read as a gather index (fwd: perm,
// inv: argsort(perm)), so the result is the same bit for bit.
//
// What bounds it on Hopper: memory, and at the paths' sizes the latency of
// two dependent reads. Per slot it streams idx (4 B), flags (1 B), the
// optional weight (sizeof(T)) and the output (sizeof(T)), and makes one
// scattered read of x[idx[i]], which waits on the read of idx[i]. On the
// paths it runs the vertex routes between orderings (2^18 to 2^20 slots,
// mostly without a finish: the entries _b4 and _b1), where the whole launch
// is one wave: its time is the ramp, two dependent round trips to memory
// and the drain of the stores. A one-call copy of the route's indices (one
// pass, no dependent read) is the floor of a launch of that size. (The
// advance pull no longer runs through it: csrc/pull_reduce.cu computes
// broadcast, route, finish and reduction over the direction's CSR in one
// launch.)
//
// The design (the first version, kept as apps/exp_route_v1.cu, took one
// slot per thread in a grid-stride loop):
// - V slots per thread, V = 16 / sizeof(T): 4 for 4-byte values, 16 for
//   bytes. A thread reads its V indices as 16-byte vectors and writes its
//   V outputs as one 16-byte store.
// - The warp's 32 items form a tile of 32 V slots that it gathers in
//   transposed order through shared memory: load k of lane l is slot
//   32 k + l, so each of the lane's V gathers of x is a warp instruction on
//   32 consecutive slots, and all V are issued before any value is used.
//   The vertex routes map neighbouring slots to neighbouring vertices (the
//   out- and in-degree orderings are alike), so these instructions touch
//   few sectors; without the transpose (each lane on its own V consecutive
//   slots) the same reads spread over V times the sectors per instruction
//   and the launch took up to 1.5x longer (PERF.md, K1/K2).
// - One wave where it fits: the grid is sized to the vector work (one
//   vector item per thread, 256 threads a block; 256 blocks at 2^18 4-byte
//   slots, 2 an SM), with no loop.
// - The output's 16-byte boundary fixes the vector items: the head before
//   it and the tail past the last whole item (fewer than V slots each) go
//   through a scalar path in the same launch, one slot per thread. An idx
//   view that does not share the output's alignment is read by words;
//   flags and weights are read per slot in the transposed order (32
//   consecutive a warp instruction). Nothing is refused for alignment and
//   nothing falls back to the plain version.
// - Cache policy, chosen by apps/exp_route.py's times: idx, flags and
//   weights are static and read again by every launch of the same route
//   (HITS runs 42 a call), so they are read past L1 under L2's evict_last,
//   which keeps them through a pull's stream between two launches, where
//   they fit a third of L2 (kKeepBytes: the vertex routes up to 2^22
//   slots); a larger route (the 2^24 advance route's 80 MB of indices and
//   flags) cannot stay and would push x out, so it is streamed under
//   evict_first; x is
//   read through L1 with the default L2 policy (evict_first lost at 2^24,
//   where x outgrows L2 and each line serves several reads); the output is
//   stored with the default policy, as the next pull reads it at once. A
//   bulk prefetch of each block's share of x into L2 gained nothing back
//   to back and up to a tenth after an L2 flush, but it needs x's length,
//   which the entries do not take (the route reads x at any index), so
//   the kernel does not prefetch.
//
// Offsets are 64-bit: 2^29 slots x 4 B overflows int32.
//
// Plain C interface (loaded with ctypes): each entry returns cudaGetLastError()
// after the launch, runs on the given stream and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

enum WeightOp { W_NONE = 0, W_ADD = 1, W_MIN = 2, W_MAX = 3, W_MUL = 4 };

constexpr int kThreads = 256;
// the route's static bytes that L2's evict_last may keep: a third of the
// H100's 50 MB L2, so that x and the pulls' streams keep the rest
constexpr long long kKeepBytes = 16ll << 20;

// Compute type of a stored type: 1-byte values compute in int32 and are
// narrowed on store, as the reference kernels do for int8.
template <typename T> struct Compute { typedef T type; };
template <> struct Compute<int8_t> { typedef int32_t type; };

template <typename C> __device__ __forceinline__ bool is_nan(C a) { return false; }
template <> __device__ __forceinline__ bool is_nan<float>(float a) { return a != a; }

// integer add and mul wrap, as torch's do
template <typename C> __device__ __forceinline__ C wrap_add(C a, C b) {
  return a + b;
}
template <> __device__ __forceinline__ int32_t wrap_add<int32_t>(int32_t a,
                                                                int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
template <typename C> __device__ __forceinline__ C wrap_mul(C a, C b) {
  return a * b;
}
template <> __device__ __forceinline__ int32_t wrap_mul<int32_t>(int32_t a,
                                                                int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}

// min/max of two numbers: fminf/fmaxf for floats, as torch.minimum and
// torch.maximum compute them on the card (so +0 and -0 compare as there)
template <typename C> __device__ __forceinline__ C min_of(C a, C b) {
  return b < a ? b : a;
}
template <> __device__ __forceinline__ float min_of<float>(float a, float b) {
  return fminf(a, b);
}
template <typename C> __device__ __forceinline__ C max_of(C a, C b) {
  return b > a ? b : a;
}
template <> __device__ __forceinline__ float max_of<float>(float a, float b) {
  return fmaxf(a, b);
}

// min/max propagate NaN, as torch.minimum/maximum and jnp.minimum/maximum do
template <int WOP, typename C>
__device__ __forceinline__ C apply_wop(C a, C b) {
  if (WOP == W_ADD) return wrap_add(a, b);
  if (WOP == W_MUL) return wrap_mul(a, b);
  if (WOP == W_MIN) return is_nan(a) ? a : (is_nan(b) ? b : min_of(a, b));
  if (WOP == W_MAX) return is_nan(a) ? a : (is_nan(b) ? b : max_of(a, b));
  return a;
}

// the L2 policy of the route's static arrays (idx, flags, weights): kept
// where they fit the share of L2 that kKeepBytes sets, else streamed
__device__ __forceinline__ uint64_t policy_route(int keep) {
  uint64_t p;
  if (keep)
    asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  else
    asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}

// Reads of the route's static arrays through the non-coherent path
// (nothing the kernel reads is written during its life), past L1, under an
// L2 policy. A byte read lands in a 32-bit register, zero- or
// sign-extended.
__device__ __forceinline__ uint32_t ld_b32(const void* p, uint64_t pol) {
  uint32_t v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.b32 %0, [%1], %2;"
      : "=r"(v) : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ uint32_t ld_u8(const void* p, uint64_t pol) {
  uint32_t v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.u8 %0, [%1], %2;"
      : "=r"(v) : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ int32_t ld_s8(const void* p, uint64_t pol) {
  int32_t v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.s8 %0, [%1], %2;"
      : "=r"(v) : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ uint4 ld_v4(const void* p, uint64_t pol) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.b32 {%0, %1, %2, %3}, "
      "[%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p), "l"(pol));
  return v;
}

// the V indices from p on as 16-byte vectors where p is 16-byte aligned,
// else as words (an idx view that does not share the output's alignment);
// all the reads issued before any is used
template <int V>
__device__ __forceinline__ void load_idx(uint32_t (&j)[V],
                                         const int32_t* p, uint64_t pol) {
  if (((uintptr_t)p & 15) == 0) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const uint4 v = ld_v4(p + 4 * q, pol);
      j[4 * q] = v.x;
      j[4 * q + 1] = v.y;
      j[4 * q + 2] = v.z;
      j[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) j[k] = ld_b32(p + k, pol);
  }
}

// a 4-byte value from its bits
template <typename T> __device__ __forceinline__ T from_bits(uint32_t u) {
  return (T)u;
}
template <> __device__ __forceinline__ float from_bits<float>(uint32_t u) {
  return __uint_as_float(u);
}

// one weight, as its compute type, under the route's L2 policy
template <typename T>
__device__ __forceinline__ typename Compute<T>::type load_w(const T* p,
                                                            uint64_t pol) {
  if constexpr (sizeof(T) == 1) return ld_s8(p, pol);
  else return from_bits<T>(ld_b32(p, pol));
}

__device__ __forceinline__ bool keep_of(uint32_t f, int exclude_self_loops) {
  return (f & 1) && !(exclude_self_loops && (f & 2));
}

// one value of x, through L1 (neighbouring slots of a vertex route read
// neighbouring values: the degree orderings are alike)
template <typename T>
__device__ __forceinline__ typename Compute<T>::type load_x(const T* p) {
  return __ldg(p);
}

// the slot i alone (the head before the output's 16-byte boundary, the tail
// past the last vector item)
template <typename T, int WOP>
__device__ __forceinline__ void scalar_item(
    const T* __restrict__ x, const int32_t* __restrict__ idx,
    const uint8_t* __restrict__ flags, const T* __restrict__ w,
    T* __restrict__ out, int64_t i, int exclude_self_loops, T ident,
    uint64_t pol_route) {
  typedef typename Compute<T>::type C;
  const bool keep = flags == nullptr
                    || keep_of(ld_u8(flags + i, pol_route),
                               exclude_self_loops);
  T v = ident;
  if (keep) {
    C r = load_x(x + (int32_t)ld_b32(idx + i, pol_route));
    if (WOP != W_NONE) r = apply_wop<WOP, C>(r, load_w(w + i, pol_route));
    v = (T)r;
  }
  out[i] = v;
}

// Thread t owns vector item t: the V slots from head + t V, the output's
// 16-byte boundary on. A warp's 32 items make its tile of 32 V slots: each
// lane reads its V indices as 16-byte vectors into the warp's shared tile,
// the warp gathers the tile in transposed order (load k of lane l is slot
// 32 k + l, so each of its V load instructions covers 32 consecutive
// slots), puts the results in the tile, and each lane stores its V as one
// 16-byte vector. Threads t < head + tail also take one scalar slot of the
// head or the tail.
template <typename T, int WOP>
__global__ void __launch_bounds__(kThreads)
route_gather_kernel(const T* __restrict__ x, const int32_t* __restrict__ idx,
                    const uint8_t* __restrict__ flags,
                    const T* __restrict__ w, T* __restrict__ out, int64_t n,
                    int64_t head, int64_t nvec, int exclude_self_loops,
                    T ident, int keep_route) {
  typedef typename Compute<T>::type C;
  constexpr int V = 16 / sizeof(T);
  constexpr int kTile = 32 * V;
  __shared__ __align__(16) uint32_t s_idx[kThreads / 32][kTile];
  __shared__ __align__(16) T s_out[kThreads / 32][kTile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t first_item = t - lane;          // the warp's first item
  const uint64_t pol_route = policy_route(keep_route);
  if (first_item < nvec) {                      // uniform across the warp
    const int items = (int)(nvec - first_item < 32 ? nvec - first_item : 32);
    const int valid = items * V;                // slots of this tile
    const int64_t tile = head + first_item * V;
    uint32_t* ti = s_idx[warp];
    T* to = s_out[warp];
    if (lane < items) {
      uint32_t j[V];
      load_idx<V>(j, idx + tile + lane * V, pol_route);
#pragma unroll
      for (int q = 0; q < V / 4; ++q)
        reinterpret_cast<uint4*>(ti + lane * V)[q] =
            make_uint4(j[4 * q], j[4 * q + 1], j[4 * q + 2], j[4 * q + 3]);
    }
    __syncwarp();
    // all of the lane's reads of flags, weights and x issued before any
    // value is used
    int32_t jj[V];
    bool keep[V];
    C wv[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int s = 32 * k + lane;              // the transposed order
      jj[k] = s < valid ? (int32_t)ti[s] : 0;
      keep[k] = s < valid
                && (flags == nullptr
                    || keep_of(ld_u8(flags + tile + s, pol_route),
                               exclude_self_loops));
      if (WOP != W_NONE && s < valid) wv[k] = load_w(w + tile + s, pol_route);
    }
    C a[V];
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (keep[k]) a[k] = load_x(x + jj[k]);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int s = 32 * k + lane;
      if (s < valid) {
        T v = ident;
        if (keep[k]) {
          C r = a[k];
          if (WOP != W_NONE) r = apply_wop<WOP, C>(r, wv[k]);
          v = (T)r;
        }
        to[s] = v;
      }
    }
    __syncwarp();
    if (lane < items)
      *reinterpret_cast<uint4*>(out + tile + lane * V) =
          reinterpret_cast<const uint4*>(to + lane * V)[0];
  }
  const int64_t tail = head + nvec * V;
  if (t < head + (n - tail))
    scalar_item<T, WOP>(x, idx, flags, w, out, t < head ? t : tail + t - head,
                        exclude_self_loops, ident, pol_route);
}

template <typename T>
int launch(const void* x, const void* idx, const void* flags, const void* w,
           void* out, long long n, int exclude_self_loops, int wop, T ident,
           void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  constexpr int V = 16 / sizeof(T);
  // slots before the output's first 16-byte boundary
  const long long head = std::min(
      n, (long long)(((16 - ((uintptr_t)out & 15)) & 15) / sizeof(T)));
  const long long nvec = (n - head) / V;
  const long long work = std::max(nvec, head + (n - head - nvec * V));
  const unsigned blocks = (unsigned)((work + kThreads - 1) / kThreads);
  // the route's static bytes: idx, and the flags and weights it has
  const long long route_bytes =
      n * (4 + (flags ? 1 : 0) + (w ? (long long)sizeof(T) : 0));
  const int keep_route = route_bytes <= kKeepBytes;
  cudaStream_t s = (cudaStream_t)stream;
  const T* xp = (const T*)x;
  const int32_t* ip = (const int32_t*)idx;
  const uint8_t* fp = (const uint8_t*)flags;
  const T* wp = (const T*)w;
  T* op = (T*)out;
#define VGL_ROUTE_LAUNCH(WOP)                                              \
  route_gather_kernel<T, WOP><<<blocks, kThreads, 0, s>>>(                 \
      xp, ip, fp, wp, op, n, head, nvec, exclude_self_loops, ident,      \
      keep_route)
  switch (wop) {
    case W_NONE: VGL_ROUTE_LAUNCH(W_NONE); break;
    case W_ADD: VGL_ROUTE_LAUNCH(W_ADD); break;
    case W_MIN: VGL_ROUTE_LAUNCH(W_MIN); break;
    case W_MAX: VGL_ROUTE_LAUNCH(W_MAX); break;
    case W_MUL: VGL_ROUTE_LAUNCH(W_MUL); break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef VGL_ROUTE_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int vgl_route_gather_f32(const void* x, const void* idx, const void* flags,
                         const void* w, void* out, long long n,
                         int exclude_self_loops, int wop, float ident,
                         void* stream) {
  return launch<float>(x, idx, flags, w, out, n, exclude_self_loops, wop,
                       ident, stream);
}

int vgl_route_gather_i32(const void* x, const void* idx, const void* flags,
                         const void* w, void* out, long long n,
                         int exclude_self_loops, int wop, int ident,
                         void* stream) {
  return launch<int32_t>(x, idx, flags, w, out, n, exclude_self_loops, wop,
                         (int32_t)ident, stream);
}

int vgl_route_gather_i8(const void* x, const void* idx, const void* flags,
                        const void* w, void* out, long long n,
                        int exclude_self_loops, int wop, int ident,
                        void* stream) {
  return launch<int8_t>(x, idx, flags, w, out, n, exclude_self_loops, wop,
                        (int8_t)ident, stream);
}

// The route without a finish moves values as their bits: one entry for
// 4-byte values (f32, i32) and one for 1-byte values (int8, uint8, bool),
// with the fewest arguments (the vertex routes' launches).
int vgl_route_gather_b4(const void* x, const void* idx, void* out,
                        long long n, void* stream) {
  return launch<int32_t>(x, idx, nullptr, nullptr, out, n, 0, W_NONE, 0,
                         stream);
}

int vgl_route_gather_b1(const void* x, const void* idx, void* out,
                        long long n, void* stream) {
  return launch<int8_t>(x, idx, nullptr, nullptr, out, n, 0, W_NONE, 0,
                        stream);
}

}  // extern "C"
