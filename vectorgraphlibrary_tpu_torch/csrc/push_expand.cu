// push_expand: the sparse push from a compacted frontier, expanded and
// scattered in one launch.
//
//   for every flat edge position p < min(ends[cap-1], ecap):
//     j     = the first frontier entry with ends[j] > p     (its owner)
//     start = j > 0 ? ends[j-1] : 0
//     d     = col_idx[row_ptr[ids[j]] + p - start]
//     out[d] = op(out[d], m)                  op in {min, max, or}, 0 <= d < n_out
//
// ends is the inclusive prefix sum of the frontier entries' degrees (0 for an
// invalid entry), so zero-degree and invalid entries own no position, and
// positions past the edge capacity drop: the function of
// ops/advance.advance_push_sparse for an edge op whose message is one int32
// constant. It replaces that push's device chain on the card (the owner mark
// scatter, cummax, four gathers, the wheres and the combine scatter, which
// ran csrc/scatter_combine.cu, the port of the TPU kernel of apps/exp_push.py,
// twice per level) with a load-balanced search over flat edge positions.
//
// What bounds it on Hopper: at the BFS push's sizes (2^10 to 2^17 edges into
// 2^20 vertices) launch latency and the caller's copy of the target; the
// kernel itself reads 4 B of col_idx per edge, coalesced within a row, and
// makes one fire-and-forget atomic per edge into the target, which stays in
// the 50 MB L2. Each block takes kThreads consecutive positions: the block
// finds together, by a kThreads-ary search over ends, the owners of its first
// and last positions; it stages that slice of ends and the owners' row
// starts in shared memory when it fits (else each thread searches ends in
// global memory), and each thread finds its own owner there (upper bound).
// No array of edge-capacity size is written. int32 atomicMin/atomicMax/
// atomicOr commute, so the result does not depend on the order of the
// threads and equals the plain version bit for bit.
//
// Plain C interface (loaded with ctypes): the entry returns cudaGetLastError()
// after the launch, runs on the given stream and allocates nothing; the
// caller has already copied the target into `out`.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Op { OP_MIN = 0, OP_MAX = 1, OP_OR = 2 };

constexpr int kThreads = 256;        // positions per block
constexpr int kStage = 2 * kThreads;  // owners a block stages in shared memory

// first i in [lo, hi) with a[i] > key, hi if none (a ascending)
__device__ __forceinline__ int upper_bound(const int32_t* a, int lo, int hi,
                                           int key) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (a[mid] > key) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// upper_bound over [0, n) of global memory by the whole block: each round
// every thread tests one sample of the remaining range and
// __syncthreads_count says how many samples are <= key (a prefix, since a
// is ascending), which cuts the range by kThreads. Two rounds up to
// kThreads^2 entries, one L2 round trip each, where one thread's binary
// search takes log2(n) dependent loads. Block-uniform.
__device__ __forceinline__ int block_upper_bound(const int32_t* a, int n,
                                                 int key) {
  int lo = 0, hi = n;           // the answer lies in [lo, hi]
  while (lo < hi) {
    const int stride = (hi - lo + kThreads - 1) / kThreads;
    const int i = lo + threadIdx.x * stride;
    const int below = __syncthreads_count(i < hi && __ldg(a + i) <= key);
    // samples lo, lo + stride, ... below them are <= key: the answer is
    // past the last of them and at most the first sample above key
    const int new_lo = below ? lo + (below - 1) * stride + 1 : lo;
    hi = min(hi, lo + below * stride);
    lo = new_lo;
  }
  return lo;
}

template <int OP>
__global__ void __launch_bounds__(kThreads)
push_expand_kernel(int32_t* __restrict__ out, uint32_t n_out,
                   const int32_t* __restrict__ row_ptr, int n_rows,
                   const int32_t* __restrict__ col_idx,
                   const int32_t* __restrict__ ids,
                   const int32_t* __restrict__ ends, int cap, int ecap,
                   int32_t m) {
  __shared__ int32_t s_ends[kStage + 1];   // s_ends[i + 1] = ends[lo + i]
  __shared__ int32_t s_row[kStage];        // row start of entry lo + i
  const int total = __ldg(ends + cap - 1);
  const int limit = total < ecap ? total : ecap;
  const int p0 = blockIdx.x * kThreads;
  if (p0 >= limit) return;                 // uniform over the block
  const int p_last = (p0 + kThreads < limit ? p0 + kThreads : limit) - 1;
  const int lo = block_upper_bound(ends, cap, p0);
  const int cnt = block_upper_bound(ends, cap, p_last) - lo + 1;
  const bool staged = cnt <= kStage;
  if (staged) {
    for (int i = threadIdx.x; i < cnt; i += kThreads) {
      s_ends[i + 1] = __ldg(ends + lo + i);
      const int id = __ldg(ids + lo + i);
      s_row[i] = __ldg(row_ptr + (id < 0 ? 0 : (id > n_rows ? n_rows : id)));
    }
    if (threadIdx.x == 0) s_ends[0] = lo > 0 ? __ldg(ends + lo - 1) : 0;
  }
  __syncthreads();
  const int p = p0 + threadIdx.x;
  if (p > p_last) return;
  int start, row;
  if (staged) {
    const int i = upper_bound(s_ends + 1, 0, cnt, p);
    start = s_ends[i];
    row = s_row[i];
  } else {
    const int j = upper_bound(ends, lo, lo + cnt, p);
    start = j > 0 ? __ldg(ends + j - 1) : 0;
    const int id = __ldg(ids + j);
    row = __ldg(row_ptr + (id < 0 ? 0 : (id > n_rows ? n_rows : id)));
  }
  const uint32_t d = (uint32_t)__ldg(col_idx + row + (p - start));
  if (d >= n_out) return;
  if (OP == OP_MIN) atomicMin(out + d, m);
  if (OP == OP_MAX) atomicMax(out + d, m);
  if (OP == OP_OR) atomicOr(out + d, m);
}

}  // namespace

extern "C" {

// out: int32 [n_out], already a copy of the target; row_ptr: int32
// [n_rows + 1]; ids, ends: int32 [cap]; ecap: the edge capacity.
int vgl_push_expand_i32(void* out, long long n_out, const void* row_ptr,
                        long long n_rows, const void* col_idx, const void* ids,
                        const void* ends, long long cap, long long ecap,
                        int msg, int op, void* stream) {
  if (n_out < 0 || n_out > 0x7fffffffLL || n_rows < 0 || n_rows > 0x7fffffffLL
      || cap > 0x7fffffffLL || ecap > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (cap <= 0 || ecap <= 0 || n_out == 0) return (int)cudaGetLastError();
  const long long blocks = (ecap + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  int32_t* o = (int32_t*)out;
  const int32_t* rp = (const int32_t*)row_ptr;
  const int32_t* ci = (const int32_t*)col_idx;
  const int32_t* ip = (const int32_t*)ids;
  const int32_t* ep = (const int32_t*)ends;
  const uint32_t no = (uint32_t)n_out;
  const int nr = (int)n_rows, c = (int)cap, ec = (int)ecap;
  switch (op) {
    case OP_MIN:
      push_expand_kernel<OP_MIN><<<(unsigned)blocks, kThreads, 0, s>>>(
          o, no, rp, nr, ci, ip, ep, c, ec, (int32_t)msg);
      break;
    case OP_MAX:
      push_expand_kernel<OP_MAX><<<(unsigned)blocks, kThreads, 0, s>>>(
          o, no, rp, nr, ci, ip, ep, c, ec, (int32_t)msg);
      break;
    case OP_OR:
      push_expand_kernel<OP_OR><<<(unsigned)blocks, kThreads, 0, s>>>(
          o, no, rp, nr, ci, ip, ep, c, ec, (int32_t)msg);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
