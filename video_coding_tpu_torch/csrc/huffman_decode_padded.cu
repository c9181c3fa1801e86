// K5 — Huffman decode of a padded lane matrix, in one of two regimes that
// the wrapper picks by shape (huffman_decode.k5_regime): "lane", one
// thread a row, for many short rows; "row", one CTA a row, for long rows.
//
// Replaces: video_coding_tpu/entropy/pallas_decode.py _kernel (the
//   pallas_call in decode_segments_pallas). Same contract: row s of the
//   (S, L) uint8 matrix (a destuffed segment, zero-padded with >= 4 guard
//   bytes) decodes into seg_blocks[s] blocks of (S, B, 64) int32 zigzag
//   coefficients, DC prediction from zero, values NOT saturated, no
//   start-state hooks, a step cap a lane. The cap never binds: a block
//   ends after at most 64 symbols (one DC, then AC symbols that each move
//   the zigzag position on by at least one; a failed AC match reads as
//   EOB), and the cap is over 65 symbols a block. Past the row a peek reads
//   what the reference's clamped, tile-padded window index reads
//   (PaddedReader), not K1's zeros.
//
// What bounds it on an H100: a row is one serial automaton. With 8,160
//   rows for one 1080p frame at ri=1 the chain of the longest lane (~150
//   symbols of ~17 a block) sets the time, not bytes: the input is S·L
//   bytes, the (S, B, 64) int32 output 12.5 MB. With a few hundred rows of
//   tens of thousands of symbols (4K frames at a restart every MCU row or
//   two: 272 rows of 2,880 blocks, 13-27 KB each) a thread a row is 9 CTAs
//   on 132 SMs, each thread a chain of ~60,000 symbols.
//
// What the "lane" regime does about it: the lane loop is K1's
//   (decode_lane_lut, with values left unsaturated): the two-level lookup
//   table built by huffman_lut.cu ahead of the decode and staged into
//   shared memory, a 64-bit window of aligned big-endian words, zero blocks
//   past the lane's end — so the output needs no zeroing pass. Rows start
//   at s·L, which is 4-byte aligned only when L is, so words are the
//   aligned words of memory with the row's first bit offset into word 0
//   (K1's unaligned source), and from bit 8·(L - 3) on a peek reads the
//   reference's clamped window instead. One 1080p frame is 255 CTAs of
//   kWarps warps, kLanesPerWarp lanes a warp (a warp of fewer lanes takes
//   fewer divergent paths a step), so nothing hides the steps of a lane's
//   chain; what the design cuts is the rest. A CTA's rows, when they take
//   at most kStageBytes, are copied into shared memory by cp.async, with
//   the lookup table, all in flight at once, so a window refill is a
//   shared load. Lanes of few blocks (a CTA's blocks within kLaneBufBytes)
//   keep them in shared memory (LaneBlocks) and the CTA writes them out at
//   the end with coalesced 16-byte stores; longer lanes flush each block
//   through K1's BlockBuf.
//
// What the "row" regime does about it: K6's self-synchronising decode
//   (huffman_decode_sync.cuh) with K5's reader: kRowThreads threads share
//   a row, each taking a run of subsequences of U bits. The row
//   (from the 16-byte boundary below its first byte) is copied into shared
//   memory by 16-byte cp.async with the lookup table when the CTA's shared
//   memory stays within kRowSmemMax (rows of up to ~190 KB; the 32 KB rows
//   of the 4K two-row lanes leave room for 3 CTAs an SM, so that their
//   272 rows are one wave on 132 SMs), else peeks read aligned words of
//   global memory. The per-subsequence records live in the caller's
//   scratch (kept in shared memory they gained under 1% at the 4K two-row
//   lanes' shape). Blocks at or past
//   seg_blocks[s] are written as zeros; every output byte is written once.
//   Each row's stats are K6's (kSyncStats) and whether the row was staged.

#include <algorithm>

#include "huffman_decode_sync.cuh"

namespace {

using namespace vct;

// A CTA is kWarps warps; lanes kLanesPerWarp of each warp decode a row
// each (fewer than 32 lanes a warp take fewer divergent paths a step), all
// of its threads stage and write out.
constexpr int kWarps = 4;
constexpr int kLanesPerWarp = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kLanes = kWarps * kLanesPerWarp;  // rows a CTA
// the reference's window array is zero-padded to a multiple of this many
// windows (one per byte)
constexpr int kWindowTile = 128;
// Rows of a CTA that take at most this many bytes are copied into shared
// memory first: a lane refills its bit window every 32 bits, and from
// global memory each refill would hold the lane for the load's latency
constexpr int kStageBytes = 16384;
// Lanes whose B blocks take at most this many bytes a CTA keep them in
// shared memory until the CTA is done (LaneBlocks)
constexpr int kLaneBufBytes = 49152;
// The "row" regime: threads a row (one CTA), and how far before its first
// subsequence a thread's round-0 guessed decode begins (tuned on the H100
// with the wrapper's U = 2,048 bits: 64, 128 or 256 threads, 512, 1,024 or
// 2,048 bits)
constexpr int kRowThreads = 128;
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kRowWarmBits = 1024;
// a "row" CTA's dynamic shared memory: a row is staged while it stays
// within kRowSmemMax (225 KB: the 227 KB a block may have, less room for
// its static shared memory)
constexpr int kRowSmemMax = 230400;
// per-row stats of the "row" regime: K6's, then 1 if the row was staged
constexpr int kRowStats = kSyncStats + 1;
// the kernel's code paths: the "lane" regime with its blocks in shared
// memory or flushed block by block, and the "row" regime
enum Path : int { kLaneBlocks, kLaneGlobal, kRow };

// Aligned 32-bit word m of the matrix as it lies in memory (little-endian),
// m = 0 the word that holds seg[0]: it starts at seg[4·m - mis], where
// mis = seg & 3; bytes outside the matrix read as zero.
__device__ inline uint32_t matrix_word(const uint8_t* seg, long long total,
                                       int mis, long long m) {
  const long long a = 4 * m - mis;  // the word's first byte
  if (a >= 0 && a + 3 < total)
    return __ldg(reinterpret_cast<const uint32_t*>(seg + a));
  uint32_t x = 0;
  for (int i = 3; i >= 0; --i)
    x = (x << 8) | (a + i >= 0 && a + i < total ? (uint32_t)seg[a + i] : 0u);
  return x;
}

// Word j of a lane, big-endian, is matrix word w0 + j, w0 = (s·L + mis) / 4:
// from the CTA's staged copy of matrix words [first, first + n_staged) when
// there is one (a word past it never holds a bit that a peek below the
// clamped tail uses, and reads as zero), else from global memory.
struct PaddedWords {
  const uint8_t* seg;
  long long total;  // S·L
  int mis;
  long long w0;
  const uint32_t* staged;
  long long first;
  int n_staged;
  __device__ uint32_t word(int j) const {
    if (staged != nullptr) {
      const long long i = w0 + j - first;
      return i < n_staged ? bswap32(staged[i]) : 0u;
    }
    return bswap32(matrix_word(seg, total, mis, w0 + j));
  }
};

// peek16 of the reference's byte-granular windows: below bit 8·NW
// (NW = L - 3 windows) the row's own bits; from there on window
// min(p / 8, NWp - 1) of the array padded to NWp windows — zero when NW is
// not a tile multiple, else the last real window (bytes L-4..L-1) again,
// at offset p % 8.
struct PaddedReader {
  BitWindow<PaddedWords> win;
  int off0;            // 8 · ((s·L + mis) & 3)
  int tail_lim;        // 8 · NW
  uint32_t tail_word;  // the last window, or 0
  __device__ int peek16(int p) {
    if (p >= tail_lim) return (int)((tail_word >> (16 - (p & 7))) & 0xFFFF);
    return win.peek16(off0 + p);
  }
};

// K5's block sink for short lanes: the lane's B blocks stay in shared
// memory — AC values as int16 in a row of B·64 + 2 halves (so that the
// lanes' rows start in different banks), position 0 unused; DC values as
// int32 — zeroed before the decode; after it the CTA writes all its lanes'
// blocks out at once with coalesced 16-byte stores. A finished block then
// costs a lane one store, where a BlockBuf flush is sixteen.
struct LaneBlocks {
  int16_t* ac;
  int32_t* dc;
  int16_t* cur;  // the block being decoded
  __device__ void put(int cof, int v) { cur[cof] = (int16_t)v; }
  __device__ void flush(int blk, int d) {
    dc[blk] = d;
    cur = ac + (blk + 1) * 64;
  }
  __device__ void zero(int) {}
};

__host__ __device__ inline int lane_halves(int B) { return B * 64 + 2; }

// shared-memory bytes of the blocks of a CTA: LaneBlocks (a multiple of
// 16) or BlockBufs
__host__ __device__ inline size_t sink_bytes(bool lane_buf, int B) {
  return lane_buf ? (size_t)kLanes * (2 * lane_halves(B) + 4 * B)
                  : (size_t)kLanes * kBufHalves * 2;
}

// The "lane" regime: rows kLanes·blockIdx.x.., a thread each.
template <bool kLaneBuf>
__device__ inline void lane_regime(
    const uint8_t* __restrict__ segbytes, int S, int L,
    const int32_t* __restrict__ seg_blocks,
    const int32_t* __restrict__ comp_sched, int B, int C,
    const int32_t* __restrict__ lo_g, const int32_t* __restrict__ hi_g,
    const int32_t* __restrict__ off_g, int T,
    const int32_t* __restrict__ values_g, int V,
    const int16_t* __restrict__ lut_g, int max_steps, bool stage,
    int32_t* __restrict__ out, int32_t* smem, uint8_t* s_comp) {
  char* bufs = reinterpret_cast<char*>(smem) + lut_smem_bytes(T, V);
  const int mis = (int)(reinterpret_cast<uintptr_t>(segbytes) & 3);
  const long long total = (long long)S * L;
  const int lane0 = blockIdx.x * kLanes;
  const int n_lanes = min(kLanes, S - lane0);
  // the matrix words that hold the CTA's rows, copied as they lie in
  // memory, all at once
  const long long first = ((long long)lane0 * L + mis) >> 2;
  int n_staged = 0;
  uint32_t* staged = nullptr;
  if (stage) {
    const long long end = (long long)(lane0 + n_lanes) * L;
    n_staged = (int)(((end - 1 + mis) >> 2) - first + 1);
    staged = reinterpret_cast<uint32_t*>(bufs + sink_bytes(kLaneBuf, B));
    for (int i = threadIdx.x; i < n_staged; i += kThreads) {
      const long long a = 4 * (first + i) - mis;
      if (a >= 0 && a + 3 < total)
        copy_async4(staged + i, segbytes + a);
      else
        staged[i] = matrix_word(segbytes, total, mis, first + i);
    }
  }
  int16_t* ac = reinterpret_cast<int16_t*>(bufs);
  int32_t* dcs = reinterpret_cast<int32_t*>(ac + kLanes * lane_halves(B));
  if (kLaneBuf) {
    const int n = (int)(sink_bytes(true, B) / 16);
    for (int i = threadIdx.x; i < n; i += kThreads)
      reinterpret_cast<int4*>(bufs)[i] = make_int4(0, 0, 0, 0);
  }
  Lut lut;
  stage_sched(s_comp, comp_sched, B, C);
  // ends in a barrier after every copy has landed, which publishes the
  // staged rows and the zeros too
  const Tables tb =
      stage_tables_lut(smem, lo_g, hi_g, off_g, T, values_g, V, lut_g, lut);

  const int t = threadIdx.x & 31;
  const int slot = (threadIdx.x >> 5) * kLanesPerWarp + t;  // in the CTA
  const int lane = lane0 + slot;
  if (t < kLanesPerWarp && slot < n_lanes) {
    const long long a0 = (long long)lane * L + mis;
    const int NW = L - 3;
    uint32_t tail_word = 0;
    if (NW % kWindowTile == 0) {
      const uint8_t* b = segbytes + (size_t)lane * L + NW - 1;
      tail_word = ((uint32_t)b[0] << 24) | ((uint32_t)b[1] << 16) |
                  ((uint32_t)b[2] << 8) | (uint32_t)b[3];
    }
    PaddedReader rd{
        {PaddedWords{segbytes, total, mis, a0 >> 2, staged, first,
                     n_staged}},
        8 * (int)(a0 & 3), 8 * NW, tail_word};
    const int nblk = min(seg_blocks[lane], B);
    if (kLaneBuf) {
      int16_t* mine = ac + slot * lane_halves(B);
      LaneBlocks sink{mine, dcs + slot * B, mine};
      decode_lane_lut<false>(rd, tb, lut, s_comp, comp_sched, nblk, B, C,
                             max_steps, 0, nullptr, sink);
    } else {
      BlockBuf bb{reinterpret_cast<int16_t*>(bufs) + slot * kBufHalves};
      bb.clear();
      GlobalBlocks sink{bb, out + (size_t)lane * B * 64};
      decode_lane_lut<false>(rd, tb, lut, s_comp, comp_sched, nblk, B, C,
                             max_steps, 0, nullptr, sink);
    }
  }
  if (!kLaneBuf) return;
  __syncthreads();
  // the CTA's lanes are one contiguous run of the output: lane by lane,
  // 16 bytes a thread
  int4* o = reinterpret_cast<int4*>(out + (size_t)lane0 * B * 64);
  for (int l = 0; l < n_lanes; ++l) {
    const int16_t* row = ac + l * lane_halves(B);
#pragma unroll 4
    for (int r = threadIdx.x; r < B * 16; r += kThreads) {
      const uint32_t* a = reinterpret_cast<const uint32_t*>(row + 4 * r);
      const uint32_t w0 = a[0], w1 = a[1];
      const int x0 =
          r & 15 ? (int)(int16_t)(w0 & 0xFFFF) : dcs[l * B + (r >> 4)];
      o[l * B * 16 + r] =
          make_int4(x0, (int)(int16_t)(w0 >> 16), (int)(int16_t)(w1 & 0xFFFF),
                    (int)(int16_t)(w1 >> 16));
    }
  }
}

// bytes of shared memory that hold a row of L bytes copied from the
// 16-byte boundary at or below its first byte
__host__ __device__ inline long long row_stage_bytes(int L) {
  return (long long)(L + 30) / 16 * 16;
}

// The "row" regime: row blockIdx.x, decoded by the CTA (see the note at
// the top and huffman_decode_sync.cuh). Shared memory: the tables, the
// threads' BlockBufs and the staged row (stage).
__device__ inline void row_regime(
    const uint8_t* __restrict__ segbytes, int S, int L,
    const int32_t* __restrict__ seg_blocks,
    const int32_t* __restrict__ comp_sched, int B, int C,
    const int32_t* __restrict__ lo_g, const int32_t* __restrict__ hi_g,
    const int32_t* __restrict__ off_g, int T,
    const int32_t* __restrict__ values_g, int V,
    const int16_t* __restrict__ lut_g, bool stage, int U, int n_sub_max,
    char* scratch, int32_t* __restrict__ stats, int32_t* __restrict__ out,
    int32_t* smem, uint8_t* s_comp) {
  __shared__ int s_last;
  __shared__ int s_tot[kRowWarps][kMaxComponents + 1];
  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  const int nblk = min(max(seg_blocks[row], 0), B);
  int32_t* dst = out + (size_t)row * B * 64;
  int* st = stats + (size_t)row * kRowStats;
  if (tid == 0) {
    st[0] = st[1] = 0;
    st[2] = kRowThreads;
    st[3] = stage;
    s_last = -1;
  }
  char* bufs = reinterpret_cast<char*>(smem) + lut_smem_bytes(T, V);
  uint8_t* srow = reinterpret_cast<uint8_t*>(
      bufs + (size_t)kRowThreads * kBufHalves * sizeof(int16_t));
  // the row's bytes lie at [a0, a0 + L) in memory; chunk i of the staged
  // copy is the 16 bytes at g0 + 16·i, bytes outside the matrix zero
  const uintptr_t seg_u = reinterpret_cast<uintptr_t>(segbytes);
  const long long total = (long long)S * L;
  const uintptr_t a0 = seg_u + (size_t)row * L;
  const uintptr_t g0 = a0 & ~(uintptr_t)15;
  const int n_chunks = (int)((a0 + L - g0 + 15) / 16);
  auto inside = [&](uintptr_t x) {
    return x >= seg_u && x < seg_u + (uintptr_t)total;
  };
  if (stage && nblk > 0) {
    for (int i = tid; i < n_chunks; i += kRowThreads) {
      const uintptr_t g = g0 + 16 * (uintptr_t)i;
      if (inside(g) && inside(g + 15)) {
        copy_async16(srow + 16 * i, reinterpret_cast<const void*>(g));
      } else {
        for (int k = 0; k < 16; ++k)
          srow[16 * i + k] =
              inside(g + k) ? *reinterpret_cast<const uint8_t*>(g + k) : 0;
      }
    }
  }
  stage_sched(s_comp, comp_sched, B, C);
  Lut lut;
  // ends in a barrier after every copy has landed
  const Tables tb =
      stage_tables_lut(smem, lo_g, hi_g, off_g, T, values_g, V, lut_g, lut);
  zero_blocks_past(dst, nblk, B);
  if (nblk == 0) return;
  const int P = schedule_period(s_comp, comp_sched, B, C);

  // the row's last nonzero byte, which bounds the subsequences
  int last = -1;
  const long long off = (long long)(a0 - g0);
  for (int i = tid; i < n_chunks; i += kRowThreads) {
    const uintptr_t g = g0 + 16 * (uintptr_t)i;
    const long long q0 = 16LL * i - off;  // row byte of the chunk's first
    if (q0 >= 0 && q0 + 15 < L && (stage || (inside(g) && inside(g + 15)))) {
      const int4 x = stage ? reinterpret_cast<const int4*>(srow)[i]
                           : __ldg(reinterpret_cast<const int4*>(g));
      const uint32_t w[4] = {(uint32_t)x.x, (uint32_t)x.y, (uint32_t)x.z,
                             (uint32_t)x.w};
      for (int k = 3; k >= 0; --k) {
        if (w[k]) {
          last = max(last, (int)q0 + 4 * k + ((31 - __clz(w[k])) >> 3));
          break;
        }
      }
    } else {
      for (int k = 15; k >= 0; --k) {
        const long long q = q0 + k;
        if (q < 0 || q >= L) continue;
        const uint8_t b = stage ? srow[16 * i + k]
                                : *reinterpret_cast<const uint8_t*>(g + k);
        if (b) {
          last = max(last, (int)q);
          break;
        }
      }
    }
  }
  for (int o = 16; o; o >>= 1) last = max(last, __shfl_xor_sync(~0u, last, o));
  if ((tid & 31) == 0) atomicMax(&s_last, last);
  __syncthreads();
  const int n_sub =
      (int)min(max((8LL * min(s_last + 1, L) + 32 + U - 1) / U, 1LL),
               (long long)n_sub_max);
  const int per = (n_sub + kRowThreads - 1) / kRowThreads;
  const int u0 = min(tid * per, n_sub), u1 = min(u0 + per, n_sub);

  const int mis = (int)(seg_u & 3);
  const long long a_rel = (long long)row * L + mis;
  const int NW = L - 3;
  uint32_t tail_word = 0;
  if (NW % kWindowTile == 0) {
    const uint8_t* b = segbytes + (size_t)row * L + NW - 1;
    tail_word = ((uint32_t)b[0] << 24) | ((uint32_t)b[1] << 16) |
                ((uint32_t)b[2] << 8) | (uint32_t)b[3];
  }
  // the staged copy begins at matrix word (g0 - (seg - mis)) / 4
  const long long first =
      ((long long)g0 - (long long)(seg_u - mis)) >> 2;
  SyncRow<PaddedReader> r{
      PaddedReader{
          {PaddedWords{segbytes, total, mis, a_rel >> 2,
                       stage ? reinterpret_cast<const uint32_t*>(srow)
                             : nullptr,
                       first, 4 * n_chunks}},
          8 * (int)(a_rel & 3), 8 * NW, tail_word},
      tb, lut, s_comp, comp_sched, C, P, B};
  const SubRecords rec = sub_records(
      scratch + (size_t)row * sub_record_bytes(n_sub_max), n_sub_max);
  const int rounds =
      sync_subsequences(r, U, kRowWarmBits, n_sub, u0, u1, rec);
  scan_subsequences<kRowThreads>(n_sub, B, rec, s_tot);
  BlockBuf bb{reinterpret_cast<int16_t*>(bufs) + tid * kBufHalves};
  bb.clear();
  write_subsequences(r, U, n_sub, u0, u1, nblk, rec, bb, dst);
  if (tid == 0) {
    st[0] = rounds;
    st[1] = n_sub;
  }
}

// One launch a call: the regime and, in the "lane" one, where a lane's
// blocks wait are the template argument.
template <int kPath>
__global__ void __launch_bounds__(kPath == kRow ? kRowThreads : kThreads,
                                  kPath == kRow ? 512 / kRowThreads : 1)
    huffman_decode_padded_kernel(
        const uint8_t* __restrict__ segbytes, int S, int L,
        const int32_t* __restrict__ seg_blocks,
        const int32_t* __restrict__ comp_sched, int B, int C,
        const int32_t* __restrict__ lo_g, const int32_t* __restrict__ hi_g,
        const int32_t* __restrict__ off_g, int T,
        const int32_t* __restrict__ values_g, int V,
        const int16_t* __restrict__ lut_g, int max_steps, bool stage, int U,
        int n_sub_max, char* scratch, int32_t* __restrict__ stats,
        int32_t* __restrict__ out) {
  extern __shared__ int4 smem4[];
  __shared__ uint8_t s_comp[kSchedStage];
  int32_t* smem = reinterpret_cast<int32_t*>(smem4);
  if constexpr (kPath == kRow)
    row_regime(segbytes, S, L, seg_blocks, comp_sched, B, C, lo_g, hi_g,
               off_g, T, values_g, V, lut_g, stage, U, n_sub_max, scratch,
               stats, out, smem, s_comp);
  else
    lane_regime<kPath == kLaneBlocks>(
        segbytes, S, L, seg_blocks, comp_sched, B, C, lo_g, hi_g, off_g, T,
        values_g, V, lut_g, max_steps, stage, out, smem, s_comp);
}

template <int kPath>
int launch(unsigned grid, unsigned threads, size_t smem, cudaStream_t stream,
           const uint8_t* segbytes, int S, int L, const int32_t* seg_blocks,
           const int32_t* comp_sched, int B, int C, const int32_t* lo,
           const int32_t* hi, const int32_t* offset, int T,
           const int32_t* values, int V, const int16_t* lut, int max_steps,
           bool stage, int U, int n_sub_max, void* scratch, int32_t* stats,
           int32_t* out) {
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(huffman_decode_padded_kernel<kPath>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  if (kPath == kRow) {
    // as many CTAs an SM as shared memory allows
    cudaFuncSetAttribute(huffman_decode_padded_kernel<kPath>,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
  }
  huffman_decode_padded_kernel<kPath><<<grid, threads, smem, stream>>>(
      segbytes, S, L, seg_blocks, comp_sched, B, C, lo, hi, offset, T, values,
      V, lut, max_steps, stage, U, n_sub_max, static_cast<char*>(scratch),
      stats, out);
  return (int)cudaGetLastError();
}

}  // namespace

// lut: lut_entries(T) int16, where the lookup table is built first. out
// needs no initialisation. regime: 0 "lane", 1 "row"; for "row" only:
// sub_bits (U), scratch (S · sub_record_bytes(n_sub_max) bytes, n_sub_max
// = min(ceil((8·L + 32) / U), INT_MAX / U)) and stats ((S, kRowStats)
// int32).
extern "C" int vct_k5_huffman_decode_padded(
    const uint8_t* segbytes, int S, int L, const int32_t* seg_blocks,
    const int32_t* comp_sched, int B, int C, const int32_t* lo,
    const int32_t* hi, const int32_t* offset, int T, const int32_t* values,
    int V, int16_t* lut, int max_steps, int regime, int sub_bits,
    void* scratch, int32_t* stats, int32_t* out, void* stream) {
  if (S <= 0) return (int)cudaGetLastError();
  const int err = vct_huffman_lut(lo, hi, offset, T, values, V, lut, stream);
  if (err != 0) return err;
  const cudaStream_t st = (cudaStream_t)stream;
  if (regime == 1) {
    // (u + 1)·U of every subsequence u stays an int bit position
    const int n_sub_max =
        (int)std::min((8LL * L + 32 + sub_bits - 1) / sub_bits,
                      (long long)(INT_MAX / sub_bits));
    size_t smem = lut_smem_bytes(T, V) +
                  (size_t)kRowThreads * kBufHalves * sizeof(int16_t);
    const bool stage = smem + row_stage_bytes(L) <= (size_t)kRowSmemMax;
    if (stage) smem += row_stage_bytes(L);
    return launch<kRow>(S, kRowThreads, smem, st, segbytes, S, L, seg_blocks,
                        comp_sched, B, C, lo, hi, offset, T, values, V, lut,
                        max_steps, stage, sub_bits, n_sub_max, scratch, stats,
                        out);
  }
  // a CTA's rows span at most kLanes·L + 6 bytes: that many words + 2
  const long long stage_words = ((long long)kLanes * L + 6) / 4 + 2;
  const bool stage = 4 * stage_words <= kStageBytes;
  const bool lane_buf = sink_bytes(true, B) <= kLaneBufBytes;
  const size_t smem = lut_smem_bytes(T, V) + sink_bytes(lane_buf, B) +
                      (stage ? 4 * (size_t)stage_words : 0);
  const unsigned grid = (S + kLanes - 1) / kLanes;
  return lane_buf
             ? launch<kLaneBlocks>(grid, kThreads, smem, st, segbytes, S, L,
                                   seg_blocks, comp_sched, B, C, lo, hi,
                                   offset, T, values, V, lut, max_steps,
                                   stage, 0, 0, nullptr, nullptr, out)
             : launch<kLaneGlobal>(grid, kThreads, smem, st, segbytes, S, L,
                                   seg_blocks, comp_sched, B, C, lo, hi,
                                   offset, T, values, V, lut, max_steps,
                                   stage, 0, 0, nullptr, nullptr, out);
}
