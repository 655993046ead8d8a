// lane_shuffle: an arbitrary shuffle inside every 128-lane row.
//
//   out[r, l] = x[r, idx[r, l] & 127]      over rows r of 128 lanes
//
// Replaces the TPU kernel vectorgraphlibrary_tpu/ops/route.py::_lane_shuffle_tpu
// (pallas_call at :146, body `kernel` :138): the collapsed middle of a Beneš
// route, between the input and the output exchange stages, as the
// stage-by-stage route (ops/route.py apply_route_stages) runs it when a
// persisted graph is loaded. Indices must lie in [0, 128); the kernel reads
// them modulo 128, so a bad index cannot read outside its row.
//
// What bounds it on Hopper: memory. Per slot it reads x and idx once and
// writes out once (12 B for 4-byte values, 6 B for 1-byte ones); at n = 2^24
// 4-byte slots that is 201 MB, 0.06 ms at 3.35 TB/s. The design keeps every
// device-memory access coalesced and vectorised: one warp per row, each lane
// loads 4 consecutive values and their 4 indices (16-byte loads for 4-byte
// values and indices), stages the row in shared memory (512 B for 4-byte
// values), reads its 4 outputs from there and stores them as one vector. The
// random access happens only in shared memory. Values are moved as raw bits,
// so float32 and int32 share the 4-byte instance and NaN payloads survive;
// int8 (and uint8/bool viewed as int8) uses the 1-byte instance.
//
// Offsets are 64-bit. Plain C interface (loaded with ctypes): the entry
// returns cudaGetLastError() after the launch, runs on the given stream and
// allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kWarpsPerBlock = 8;

template <typename T> struct Vec4;
template <> struct Vec4<uint32_t> { typedef uint4 type; };
template <> struct Vec4<uint8_t> { typedef uchar4 type; };

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
lane_shuffle_kernel(const T* __restrict__ x, const int32_t* __restrict__ idx,
                    T* __restrict__ out, int64_t rows) {
  typedef typename Vec4<T>::type V;
  __shared__ __align__(16) T row_buf[kWarpsPerBlock][kLanes];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  T* buf = row_buf[warp];
  const int64_t stride = (int64_t)gridDim.x * kWarpsPerBlock;
  for (int64_t r = (int64_t)blockIdx.x * kWarpsPerBlock + warp; r < rows;
       r += stride) {
    const int64_t base = r * kLanes + lane * 4;
    const V v = *reinterpret_cast<const V*>(x + base);
    const int4 id = __ldg(reinterpret_cast<const int4*>(idx + base));
    *reinterpret_cast<V*>(buf + lane * 4) = v;
    __syncwarp();
    V o;
    o.x = buf[id.x & (kLanes - 1)];
    o.y = buf[id.y & (kLanes - 1)];
    o.z = buf[id.z & (kLanes - 1)];
    o.w = buf[id.w & (kLanes - 1)];
    *reinterpret_cast<V*>(out + base) = o;
    __syncwarp();   // the next row overwrites buf
  }
}

template <typename T>
int launch(const void* x, const void* idx, void* out, long long rows,
           void* stream) {
  if (rows <= 0) return (int)cudaGetLastError();
  long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  // enough blocks to fill 132 SMs many times over; the loop covers the rest
  if (blocks > 132 * 32) blocks = 132 * 32;
  lane_shuffle_kernel<T><<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                           (cudaStream_t)stream>>>(
      (const T*)x, (const int32_t*)idx, (T*)out, rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// elem_bytes: 4 (float32, int32) or 1 (int8). x, idx and out must be
// 16-byte aligned, each a contiguous [rows, 128] array.
int vgl_lane_shuffle(const void* x, const void* idx, void* out,
                     long long rows, int elem_bytes, void* stream) {
  if (elem_bytes == 4) return launch<uint32_t>(x, idx, out, rows, stream);
  if (elem_bytes == 1) return launch<uint8_t>(x, idx, out, rows, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
