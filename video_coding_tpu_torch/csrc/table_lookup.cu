// K9 — small-table lookup: out[i] = table[idx[i]] for an int32 table of at
// most 1024 entries; an index outside [0, T) gives 0.
//
// Replaces: video_coding_tpu/ops/lookup.py _kernel (the pallas_call in
//   _lookup_pallas, reached through table_lookup). Same contract: the
//   result has the shape of idx, an out-of-range index matches no table
//   row and yields 0, nothing is read out of bounds.
//
// What bounds it on an H100: bytes. Every element is 4 bytes in and 4 bytes
//   out (395 MB for the (783,360, 63) lookup of a 16-frame 1080p dispatch);
//   the table itself is at most 4 KB.
//
// What the design does about it: the TPU kernel splits the index into
//   idx >> 7 and idx & 127 and does one within-register gather per 128-entry
//   table row because Mosaic can only gather inside one vector register. A
//   CUDA thread can index shared memory directly: the table is staged once a
//   CTA, the indices are read and the results written as 16-byte vectors by
//   neighbouring threads (a scalar loop covers an unaligned head and the
//   tail), and a grid-stride loop keeps every SM busy with a fixed grid.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxTable = 1024;
constexpr int kThreads = 256;

__device__ __forceinline__ int32_t pick(const int32_t* tab, int T, int32_t i) {
  return ((uint32_t)i < (uint32_t)T) ? tab[i] : 0;
}

__global__ void table_lookup_kernel(const int32_t* __restrict__ table, int T,
                                    const int32_t* __restrict__ idx,
                                    long long n, long long head,
                                    int32_t* __restrict__ out) {
  __shared__ int32_t tab[kMaxTable];
  for (int i = threadIdx.x; i < T; i += blockDim.x) tab[i] = table[i];
  __syncthreads();

  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // [0, head): scalar, up to the first 16-byte boundary of both arrays
  for (long long i = tid; i < head; i += stride)
    out[i] = pick(tab, T, idx[i]);
  // [head, head + 4 * n4): 16-byte vectors
  const long long n4 = (n - head) / 4;
  const int4* idx4 = reinterpret_cast<const int4*>(idx + head);
  int4* out4 = reinterpret_cast<int4*>(out + head);
  for (long long v = tid; v < n4; v += stride) {
    const int4 q = idx4[v];
    out4[v] = make_int4(pick(tab, T, q.x), pick(tab, T, q.y),
                        pick(tab, T, q.z), pick(tab, T, q.w));
  }
  // the tail
  for (long long i = head + 4 * n4 + tid; i < n; i += stride)
    out[i] = pick(tab, T, idx[i]);
}

}  // namespace

extern "C" int vct_k9_table_lookup(const int32_t* table, int T,
                                   const int32_t* idx, long long n,
                                   int32_t* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (T < 1 || T > kMaxTable) return (int)cudaErrorInvalidValue;
  // vectors need idx and out 16-byte aligned at the same element offset
  const uintptr_t a = reinterpret_cast<uintptr_t>(idx);
  const uintptr_t b = reinterpret_cast<uintptr_t>(out);
  long long head = n;
  if ((a & 15) == (b & 15)) {
    head = (long long)(((16 - (a & 15)) & 15) / 4);
    if (head > n) head = n;
  }
  const long long want = (n / 4 + kThreads - 1) / kThreads + 1;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  table_lookup_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      table, T, idx, n, head, out);
  return (int)cudaGetLastError();
}
