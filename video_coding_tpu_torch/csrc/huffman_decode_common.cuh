// Shared device code of the Huffman decode kernels (K1, K5, K6, K7) and of
// the lookup-table builder: the canonical-range tables in shared memory,
// the code match and the magnitude sign extension. The lane loop, the bit
// window and the lookup table itself are in huffman_decode_lut.cuh.
//
// The automaton: DC code + magnitude, then AC (run, size) codes +
// magnitudes until EOB or position 63, DC prediction per component.

#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace vct {

constexpr int kMaxComponents = 4;

struct Tables {
  const int32_t* lo;
  const int32_t* hi;
  const int32_t* off;
  const int32_t* values;
  int V;
};

__host__ __device__ inline size_t table_ints(int T, int V) {
  return ((size_t)3 * T * 16 + V + 3) / 4 * 4;  // keeps 16-byte alignment
}

// Copy the range tables into shared memory (every thread of the CTA calls
// this; it ends in a barrier).
__device__ inline Tables stage_tables(int32_t* smem, const int32_t* lo_g,
                                      const int32_t* hi_g,
                                      const int32_t* off_g, int T,
                                      const int32_t* values_g, int V) {
  int32_t* lo = smem;
  int32_t* hi = lo + T * 16;
  int32_t* off = hi + T * 16;
  int32_t* values = off + T * 16;
  for (int i = threadIdx.x; i < T * 16; i += blockDim.x) {
    lo[i] = lo_g[i];
    hi[i] = hi_g[i];
    off[i] = off_g[i];
  }
  for (int i = threadIdx.x; i < V; i += blockDim.x) values[i] = values_g[i];
  __syncthreads();
  return Tables{lo, hi, off, values, V};
}

// Match the 16-bit window against table row t: the sum over matching
// lengths (ranges of one table are disjoint, so at most one matches; no
// match gives length 0 and data 0).
__device__ inline void match(const Tables& tb, int t, int w16, int& code_len,
                             int& data) {
  int lo_sel = 0, off_sel = 0;
  code_len = 0;
#pragma unroll
  for (int l = 0; l < 16; ++l) {
    if (w16 >= tb.lo[t * 16 + l] && w16 < tb.hi[t * 16 + l]) {
      code_len += l + 1;
      lo_sel += tb.lo[t * 16 + l];
      off_sel += tb.off[t * 16 + l];
    }
  }
  data = 0;
  if (code_len > 0) {
    int idx = off_sel + ((w16 - lo_sel) >> (16 - min(code_len, 16)));
    idx = min(max(idx, 0), tb.V - 1);
    data = tb.values[idx] & 0xFF;
  }
}

// JPEG magnitude sign extension of a cat-bit code, cat in 1..16.
__device__ inline int extend(int cat, int code) {
  return (code & (1 << (cat - 1))) ? code : code - (1 << cat) + 1;
}

}  // namespace vct
