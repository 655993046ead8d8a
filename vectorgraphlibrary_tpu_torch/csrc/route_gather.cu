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
// What bounds it on Hopper: memory. Per slot it streams idx (4 B), flags (1 B),
// the optional weight (sizeof(T)) and the output (sizeof(T)), and makes one
// scattered read of x[idx[i]]: a 4-byte value costs a whole 32-byte sector
// unless neighbouring slots hit the same sector, so the random read dominates
// the bytes moved. Masked slots (non-edges, self-loops) skip that read. This
// first version is a grid-stride loop, one slot per thread. The advance pull
// no longer runs through it: csrc/pull_reduce.cu computes the whole chain
// (broadcast, this route with the finish, the per-destination reduction)
// over the direction's CSR in one launch. On the paths this kernel runs the
// vertex routes between orderings.
//
// Offsets are 64-bit: 2^29 slots x 4 B overflows int32.
//
// Plain C interface (loaded with ctypes): each entry returns cudaGetLastError()
// after the launch, runs on the given stream and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum WeightOp { W_NONE = 0, W_ADD = 1, W_MIN = 2, W_MAX = 3, W_MUL = 4 };

// Compute type of a stored type: 1-byte values compute in int32 and are
// narrowed on store, as the reference kernels do for int8.
template <typename T> struct Compute { typedef T type; };
template <> struct Compute<int8_t> { typedef int32_t type; };

template <typename C> __device__ __forceinline__ bool is_nan(C a) { return false; }
template <> __device__ __forceinline__ bool is_nan<float>(float a) { return a != a; }

// min/max propagate NaN, as torch.minimum/maximum and jnp.minimum/maximum do
template <int WOP, typename C>
__device__ __forceinline__ C apply_wop(C a, C b) {
  if (WOP == W_ADD) return a + b;
  if (WOP == W_MUL) return a * b;
  if (WOP == W_MIN) return is_nan(a) ? a : (is_nan(b) ? b : (b < a ? b : a));
  if (WOP == W_MAX) return is_nan(a) ? a : (is_nan(b) ? b : (b > a ? b : a));
  return a;
}

template <typename T, int WOP>
__global__ void route_gather_kernel(const T* __restrict__ x,
                                    const int32_t* __restrict__ idx,
                                    const uint8_t* __restrict__ flags,
                                    const T* __restrict__ w,
                                    T* __restrict__ out, int64_t n,
                                    int exclude_self_loops, T ident) {
  typedef typename Compute<T>::type C;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    bool keep = true;
    if (flags != nullptr) {
      const uint8_t f = flags[i];
      keep = (f & 1) && !(exclude_self_loops && (f & 2));
    }
    T v = ident;
    if (keep) {
      C a = (C)__ldg(x + (int64_t)__ldg(idx + i));
      if (WOP != W_NONE) a = apply_wop<WOP, C>(a, (C)w[i]);
      v = (T)a;
    }
    out[i] = v;
  }
}

template <typename T>
int launch(const void* x, const void* idx, const void* flags, const void* w,
           void* out, long long n, int exclude_self_loops, int wop, T ident,
           void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  // enough blocks to fill 132 SMs many times over; the loop covers the rest
  if (blocks > 132 * 64) blocks = 132 * 64;
  cudaStream_t s = (cudaStream_t)stream;
  const T* xp = (const T*)x;
  const int32_t* ip = (const int32_t*)idx;
  const uint8_t* fp = (const uint8_t*)flags;
  const T* wp = (const T*)w;
  T* op = (T*)out;
  switch (wop) {
    case W_NONE:
      route_gather_kernel<T, W_NONE><<<(unsigned)blocks, threads, 0, s>>>(
          xp, ip, fp, wp, op, n, exclude_self_loops, ident);
      break;
    case W_ADD:
      route_gather_kernel<T, W_ADD><<<(unsigned)blocks, threads, 0, s>>>(
          xp, ip, fp, wp, op, n, exclude_self_loops, ident);
      break;
    case W_MIN:
      route_gather_kernel<T, W_MIN><<<(unsigned)blocks, threads, 0, s>>>(
          xp, ip, fp, wp, op, n, exclude_self_loops, ident);
      break;
    case W_MAX:
      route_gather_kernel<T, W_MAX><<<(unsigned)blocks, threads, 0, s>>>(
          xp, ip, fp, wp, op, n, exclude_self_loops, ident);
      break;
    case W_MUL:
      route_gather_kernel<T, W_MUL><<<(unsigned)blocks, threads, 0, s>>>(
          xp, ip, fp, wp, op, n, exclude_self_loops, ident);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
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

}  // extern "C"
