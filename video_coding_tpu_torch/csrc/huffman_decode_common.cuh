// Shared device code of the Huffman decode kernels (K1, K5, K6, K7): the
// canonical-range tables in shared memory, the code match and the
// magnitude sign extension; and K5's per-lane symbol loop (K1, K6 and K7
// decode through huffman_decode_lut.cuh instead) —
//
//   decode_lane_windows  reads 16-bit peeks through the clamped window index
//                        of a padded lane matrix (K5, byte-granular); values
//                        not saturated; a step cap a lane (its cap a block
//                        served K6 before K6 left this loop).
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

// ---------------------------------------------------------------------------
// Window form (K5). The reference kernels precompute one 32-bit
// big-endian window per `unit` bytes of the lane's row (unit = 1 for K5,
// 2 for K6), zero-pad the window array to a tile multiple NWp, and read 16
// bits at a time from window clamp(bitpos / (8·unit), 0, NWp - 1). Inside
// the row that is the plain stream; past it a peek reads zero windows, or —
// when the window count is already a tile multiple — the last real window
// again. peek16 keeps exactly that, and serves the in-row peeks from an
// 8-byte register cache that is refilled as the cursor moves on.
struct WindowReader {
  const uint8_t* row;
  int L;       // bytes in the row
  int ushift;  // log2 of the window stride in bits: 3 (K5) or 4 (K6)
  int NW;      // real windows
  int NWp;     // windows after padding
  uint64_t cache = 0;
  int cbyte = INT_MIN / 2;  // first byte of the cache

  __device__ int peek16(int bitpos) {
    int wp = bitpos >> ushift;
    const int sh = bitpos & ((1 << ushift) - 1);
    if (wp >= NW) {
      wp = min(wp, NWp - 1);
      if (wp >= NW) return 0;
      const uint8_t* b = row + (wp << (ushift - 3));
      const uint32_t w32 = ((uint32_t)b[0] << 24) | ((uint32_t)b[1] << 16) |
                           ((uint32_t)b[2] << 8) | (uint32_t)b[3];
      return (int)((w32 >> (16 - sh)) & 0xFFFF);
    }
    const int byte = bitpos >> 3;
    if (byte < cbyte || byte - cbyte > 5) {
      cbyte = byte;
      cache = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        cache = (cache << 8) | (byte + k < L ? (uint64_t)row[byte + k] : 0ull);
    }
    return (int)((cache >> (48 - (bitpos - 8 * cbyte))) & 0xFFFF);
  }
};

// ``sink.begin(blk)``, ``sink.put(cof, value)``, ``sink.end(blk)`` receive
// the coefficients of each decoded block. ``total_cap`` bounds the lane's
// symbols; ``block_cap`` bounds one block's — a block that reaches it is
// left as it stands and the next block starts afresh (DC phase, position
// 0) at the bit cursor where it stopped.
template <class Sink>
__device__ inline void decode_lane_windows(WindowReader& rd, const Tables& tb,
                                           const int32_t* comp_sched,
                                           int nblk, int C, int total_cap,
                                           int block_cap, Sink& sink) {
  int dc[kMaxComponents] = {0, 0, 0, 0};
  int bitpos = 0, steps = 0, blk = 0;
  int comp = 0, cof = 0, bsteps = 0;
  bool in_ac = false, fresh = true;
  // one flat loop over symbols, the block being part of the state: the
  // lanes of a warp then only wait for each other symbol by symbol, not
  // for the slowest lane of every block
  while (blk < nblk && steps < total_cap) {
    if (fresh) {
      comp = min(max(__ldg(comp_sched + blk), 0), C - 1);
      sink.begin(blk);
      cof = 0;
      bsteps = 0;
      in_ac = false;
      fresh = false;
    }
    ++steps;
    ++bsteps;
    int code_len, data;
    match(tb, comp + (in_ac ? C : 0), rd.peek16(bitpos), code_len, data);
    const int run = in_ac ? (data >> 4) & 0xF : 0;
    const int cat = min(in_ac ? (data & 0xF) : data, 16);
    int val = 0;
    if (cat > 0)
      val = extend(cat, rd.peek16(bitpos + code_len) >> (16 - cat));
    bitpos += code_len + cat;
    bool done = false;
    if (!in_ac) {
      dc[comp] += val;
      sink.put(0, dc[comp]);
      in_ac = true;
      cof = 1;
    } else if (run == 0 && cat == 0) {  // EOB
      done = true;
    } else {
      const int nc = cof + run;
      if (nc < 64) sink.put(nc, val);
      done = nc + 1 >= 64;
      cof = nc + 1;
    }
    if (done || bsteps >= block_cap) {
      sink.end(blk);
      ++blk;
      fresh = true;
    }
  }
  // a lane stopped by its cap inside a block still hands that block over
  if (!fresh) sink.end(blk);
}

}  // namespace vct
