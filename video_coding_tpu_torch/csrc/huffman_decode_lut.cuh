// Shared device code of the redesigned Huffman decode kernels K1, K5, K6
// and K7: the direct-lookup table beside the range tables, a bit window fed
// by aligned 32-bit word loads, the one-symbol decode step, a per-thread
// int16 block buffer that leaves as whole 16-byte stores, and the lane
// loop of K1, K5 and K7 (decode_lane_lut), which differ in their word
// source and, for K5, in leaving values unsaturated.
//
// The lookup table (built by huffman_lut.cu, plain version
// huffman_decode.decode_lut_plain) has two levels. Level 1 has 2^kLutBits
// entries per table row, indexed by the top kLutBits bits of the 16-bit
// window: (code_len << 8) | data where every window with that prefix gives
// that match() (code_len <= 16); else kLutPooled | slot, where slot < kLutPool
// is a level-2 block of 2^(16 - kLutBits) entries (code_len << 8) | data, one
// per window of the prefix (the long codes); else, once the blocks are
// used up, kLutFallback: the range match runs. The table is therefore exact
// for any range table, canonical or not; canonical tables fill a few blocks.

#pragma once

#include "huffman_decode_common.cuh"

namespace vct {

constexpr int kLutBits = 10;  // = huffman_decode.LUT_BITS
constexpr int kLutSize = 1 << kLutBits;
constexpr int kLutSpan = 1 << (16 - kLutBits);  // windows of a prefix
constexpr int kLutPool = 32;                     // = huffman_decode.LUT_POOL
constexpr unsigned kLutPooled = 0x8000;
constexpr unsigned kLutFallback = 0xC000;

// int16 entries of the table: T level-1 rows, then the level-2 blocks
__host__ __device__ inline int lut_entries(int T) {
  return T * kLutSize + kLutPool * kLutSpan;
}
constexpr int kBufHalves = 68;  // int16 per block buffer row (136 bytes)

struct Lut {
  const uint16_t* l1;    // (T, kLutSize)
  const uint16_t* pool;  // (kLutPool, kLutSpan)
};

// Builds the table into lut (lut_entries(T) int16) on `stream`
// (huffman_lut.cu); K1, K5, K6 and K7 call it ahead of their decode.
extern "C" int vct_huffman_lut(const int32_t* lo, const int32_t* hi,
                               const int32_t* offset, int T,
                               const int32_t* values, int V, int16_t* lut,
                               void* stream);

__host__ __device__ inline size_t lut_smem_bytes(int T, int V) {
  return table_ints(T, V) * sizeof(int32_t) +
         (size_t)lut_entries(T) * sizeof(uint16_t);
}

// Copies from global to shared memory that no register passes through, so
// that a thread has all of its in flight at once; copy_async_wait_all
// waits for the thread's own.
__device__ inline void copy_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem_src)
               : "memory");
}
__device__ inline void copy_async4(void* smem_dst, const void* gmem_src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem_src)
               : "memory");
}
__device__ inline void copy_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copy the range tables and the lookup table into shared memory (every
// thread of the CTA calls this; it ends in a barrier, after the thread's
// earlier copy_async copies have landed too). The lookup table follows the
// range tables; both are 16-byte aligned.
__device__ inline Tables stage_tables_lut(int32_t* smem, const int32_t* lo_g,
                                          const int32_t* hi_g,
                                          const int32_t* off_g, int T,
                                          const int32_t* values_g, int V,
                                          const int16_t* lut_g, Lut& lut) {
  int4* dst = reinterpret_cast<int4*>(smem + table_ints(T, V));
  const int4* src = reinterpret_cast<const int4*>(lut_g);
  const int n = lut_entries(T) * 2 / 16;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    copy_async16(dst + i, src + i);
  copy_async_wait_all();
  lut.l1 = reinterpret_cast<const uint16_t*>(dst);
  lut.pool = lut.l1 + T * kLutSize;
  return stage_tables(smem, lo_g, hi_g, off_g, T, values_g, V);
}

// Big-endian 32-bit word from 4 bytes loaded as one little-endian word.
__device__ inline uint32_t bswap32(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

// A 64-bit window over a byte source: words k and k+1 (big-endian), so a
// 16-bit peek at any bit of word k is a shift. The cursor only moves
// forward in a decode; a step of one word shifts in word k+2, loaded one
// step ahead, so the load's latency is off the symbol chain.
template <class Src>
struct BitWindow {
  Src src;
  uint64_t buf = 0;
  uint32_t nxt = 0;  // word k+2
  int k = INT_MIN / 2;

  __device__ int peek16(int p) {
    const int kk = p >> 5;
    if (kk != k) {
      if (kk == k + 1)
        buf = (buf << 32) | nxt;
      else
        buf = ((uint64_t)src.word(kk) << 32) | src.word(kk + 1);
      nxt = src.word(kk + 2);
      k = kk;
    }
    return (int)((buf << (p & 31)) >> 48);
  }
};

// One symbol at bit ``bitpos`` against table row t: code length + size
// bits consumed, AC run, size category and magnitude — match() and the
// magnitude peek of the reference automaton, through the lookup table.
template <class Reader>
__device__ inline void decode_symbol(Reader& rd, const Tables& tb,
                                     const Lut& lut, int t, bool in_ac,
                                     int bitpos, int& used, int& run,
                                     int& cat, int& val) {
  const int w16 = rd.peek16(bitpos);
  unsigned e = lut.l1[t * kLutSize + (w16 >> (16 - kLutBits))];
  int code_len, data;
  if (e >= kLutFallback) {
    match(tb, t, w16, code_len, data);
  } else {
    if (e & kLutPooled)
      e = lut.pool[(int)(e & 0x3FFF) * kLutSpan + (w16 & (kLutSpan - 1))];
    code_len = (int)(e >> 8);
    data = (int)(e & 0xFF);
  }
  run = in_ac ? (data >> 4) & 0xF : 0;
  // baseline size categories are <= 11; 16 bounds the 16-bit peek
  cat = min(in_ac ? (data & 0xF) : data, 16);
  val = cat > 0 ? extend(cat, rd.peek16(bitpos + code_len) >> (16 - cat)) : 0;
  used = code_len + cat;
}

// The AC coefficients of the block being decoded, as int16 in shared
// memory (an AC magnitude has at most 15 bits, so it fits unsaturated);
// the DC value stays in a register. Rows are 34 words apart, so the 8-byte
// accesses of a half-warp hit distinct banks.
struct BlockBuf {
  int16_t* b;

  __device__ void clear() {
    uint2* s = reinterpret_cast<uint2*>(b);
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = make_uint2(0, 0);
  }
  __device__ void put(int cof, int v) { b[cof] = (int16_t)v; }
  // Write the block as sixteen 16-byte stores (position 0 = dc) and leave
  // the buffer zeroed for the next one.
  __device__ void flush(int32_t* dst, int dc) {
    uint2* s = reinterpret_cast<uint2*>(b);
    int4* o = reinterpret_cast<int4*>(dst);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint2 v = s[i];
      s[i] = make_uint2(0, 0);
      const int x0 = i ? (int)(int16_t)(v.x & 0xFFFF) : dc;
      o[i] = make_int4(x0, (int)(int16_t)(v.x >> 16),
                       (int)(int16_t)(v.y & 0xFFFF), (int)(int16_t)(v.y >> 16));
    }
  }
};

__device__ inline void store_zero_block(int32_t* dst) {
  int4* o = reinterpret_cast<int4*>(dst);
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i] = make_int4(0, 0, 0, 0);
}

// The block sink of decode_lane_lut for K1 and K7: block blk of the lane's
// (B, 64) output dst leaves from a BlockBuf as sixteen 16-byte stores when
// it is done, and a block the lane does not reach as zeros.
struct GlobalBlocks {
  BlockBuf bb;
  int32_t* dst;
  __device__ void put(int cof, int v) { bb.put(cof, v); }
  __device__ void flush(int blk, int dc) {
    bb.flush(dst + (size_t)blk * 64, dc);
  }
  __device__ void zero(int blk) { store_zero_block(dst + (size_t)blk * 64); }
};

// The component of each of the schedule's first kSchedStage blocks, as
// bytes in shared memory (later blocks read comp_sched itself). Every
// thread of the CTA calls this; the caller's next barrier publishes it.
constexpr int kSchedStage = 1024;
__device__ inline void stage_sched(uint8_t* dst, const int32_t* comp_sched,
                                   int n, int C) {
  for (int i = threadIdx.x; i < min(n, kSchedStage); i += blockDim.x)
    dst[i] = (uint8_t)min(max(__ldg(comp_sched + i), 0), C - 1);
}
__device__ inline int sched_comp(const uint8_t* staged,
                                 const int32_t* comp_sched, int i, int C) {
  return i < kSchedStage ? staged[i]
                         : min(max(__ldg(comp_sched + i), 0), C - 1);
}

// dc[comp] += v over a register array without dynamic indexing.
__device__ inline int add_dc(int (&dc)[kMaxComponents], int comp, int v) {
  int r = 0;
#pragma unroll
  for (int c = 0; c < kMaxComponents; ++c) {
    if (c == comp) {
      dc[c] = (int)((unsigned)dc[c] + (unsigned)v);  // wraps mod 2^32
      r = dc[c];
    }
  }
  return r;
}

// One lane of K1, K5 or K7: blocks of the schedule from bit `bitpos` of
// the reader's stream with the DC predictors dc0[0..C) (null: zeros), until
// nblk blocks or max_steps symbols — a block cut by the cap handed over as
// it stands — and then zero blocks up to B, so every block of the lane is
// written. The sink takes AC values (`put(cof, v)` of the block being
// decoded), each finished block (`flush(blk, dc)`) and each block the lane
// does not reach (`zero(blk)`). kSaturate: values saturated to int16 (K1,
// K7), or not (K5: the DC predictor wraps mod 2^32 and is written as it
// is; an AC magnitude has at most 15 bits, so the clamp never changes
// one).
// `rd.peek16(p)` gives the 16 stream bits at bit p; the positions asked
// for never decrease.
template <bool kSaturate, class Reader, class Sink>
__device__ inline void decode_lane_lut(Reader& rd, const Tables& tb,
                                       const Lut& lut, const uint8_t* s_comp,
                                       const int32_t* comp_sched, int nblk,
                                       int B, int C, int max_steps,
                                       int bitpos, const int32_t* dc0,
                                       Sink& sink) {
  int dc[kMaxComponents] = {0, 0, 0, 0};
  if (dc0 != nullptr)
    for (int c = 0; c < C; ++c) dc[c] = dc0[c];
  int blk = 0, cof = 0, steps = 0, comp = 0, dcw = 0;
  bool in_ac = false;
  while (blk < nblk && steps < max_steps) {
    ++steps;
    // schedule entries past the tables clamp to the last component (the
    // sessions never produce them)
    if (!in_ac) comp = sched_comp(s_comp, comp_sched, blk, C);
    int used, run, cat, val;
    decode_symbol(rd, tb, lut, comp + (in_ac ? C : 0), in_ac, bitpos, used,
                  run, cat, val);
    bitpos += used;
    if (!in_ac) {
      dcw = add_dc(dc, comp, val);
      if (kSaturate) dcw = min(max(dcw, -32768), 32767);
      in_ac = true;
      cof = 1;
    } else if (run == 0 && cat == 0) {  // EOB
      sink.flush(blk, dcw);
      ++blk;
      in_ac = false;
    } else {
      const int nc = cof + run;
      if (nc < 64 && val)
        sink.put(nc, kSaturate ? min(max(val, -32768), 32767) : val);
      if (nc + 1 >= 64) {
        sink.flush(blk, dcw);
        ++blk;
        in_ac = false;
      } else {
        cof = nc + 1;
      }
    }
  }
  // a lane stopped by its cap inside a block still hands that block over
  if (in_ac) sink.flush(blk++, dcw);
  for (blk = max(blk, 0); blk < B; ++blk) sink.zero(blk);
}

}  // namespace vct
