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
// Monoid.scatter_at("add"), which builds the triangle count's bitmaps
// (models/tc._tc_build_bits: one bit added per deduplicated edge, so the add
// is an or). The BFS push runs csrc/push_expand.cu instead.
//
// What bounds it on Hopper: one 4-byte atomic per message, plus streaming idx
// and msg (8 B per message). At the BFS push's shapes the target (4 MB at
// v_pad = 2^20) lives in the 50 MB L2, so the atomics are resolved there and
// the kernel is bound by L2 atomic throughput, and at small message counts by
// launch latency. The TPU needed a sequential grid because its VMEM row update
// is a read-modify-write; here atomicMin/atomicMax/atomicOr commute on int32,
// so the result does not depend on the order of the threads: it is the same on
// every run and equals the plain version bit for bit. So does atomicAdd on
// int32: a sum modulo 2^32 is exact in any order. There is no f32 add: float
// sums taken by atomics round in the order the threads arrive, which changes
// from run to run, so the wrapper raises for it. The return value of each
// atomic is unused, so it compiles to a fire-and-forget reduction (RED).
// First version: a grid-stride loop, one message per thread.
//
// The f32 min and max (the sparse push of SSSP: dist[dst] = min(dist[dst],
// dist[src] + w)) are atomics on the float's bit pattern, which orders like
// the float itself once the sign is looked at: a message with the sign bit
// clear takes a signed-int atomicMin (atomicMax for max), one with the sign
// bit set an unsigned atomicMax (atomicMin for max). Both commute, so the
// result is again independent of the order of the threads and equal to the
// plain version bit for bit. Two cases differ from torch's amin/amax: -0.0
// orders below +0.0 (torch takes them as equal and keeps whichever came
// first), and a NaN is ordered by its bit pattern (above +inf or below -inf)
// and not propagated. Distances are non-negative and never NaN.
//
// Plain C interface (loaded with ctypes): the entry returns cudaGetLastError()
// after the launch, runs on the given stream and allocates nothing; the
// caller has already copied the target into `out`.

#include <cuda_runtime.h>
#include <stdint.h>

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
    const int32_t bits = __float_as_int(m);
    // sign clear: floats order as signed ints; sign set: as unsigned ints,
    // reversed
    if ((bits >= 0) == IS_MIN) {
      if (bits >= 0) atomicMin((int32_t*)(out + d), bits);
      else atomicMin((uint32_t*)(out + d), (uint32_t)bits);
    } else {
      if (bits >= 0) atomicMax((int32_t*)(out + d), bits);
      else atomicMax((uint32_t*)(out + d), (uint32_t)bits);
    }
  }
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

}  // extern "C"
