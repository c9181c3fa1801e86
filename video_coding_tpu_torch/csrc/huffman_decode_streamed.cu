// K6 — streamed Huffman decode of long segments: one CTA a row, many
// threads inside each row.
//
// Replaces: video_coding_tpu/entropy/pallas_decode.py _kernel_bs (the
//   pallas_call in decode_segments_pallas_bs). Same contract: row s of the
//   (S, L) uint8 matrix decodes into (S, B, 64) int32 zigzag coefficients,
//   the block's component taken from the periodic schedule, DC prediction
//   from zero, values NOT saturated, blocks at or past seg_blocks[s]
//   written as zeros, and a cap of 134 symbols a block — which never binds:
//   a block ends after at most 64 symbols (one DC, then AC symbols that
//   each move the zigzag position on by at least one; a failed AC match
//   reads as EOB). Peeks read the reference's stride-16 windows: the row's
//   bits inside it, past it zeros or — when the window count is a multiple
//   of 8 — the last window again (RowReader).
//
// What bounds it on an H100: a row is one serial chain of ~11,500 symbols
//   (one MCU row of a 1080p frame is 720 blocks) and a dispatch has ~1,000
//   rows, far too few chains for 132 SMs. The (S, B, 64) int32 output is
//   ~200 MB, 0.06 ms of bytes.
//
// What the design does about it: a self-synchronising parallel decode
//   (after Weißenberger & Schmidt, ICPP 2018). The row's data is cut into
//   subsequences of U bits, one thread each. The decoder state at a symbol
//   boundary is (bit position, DC/AC phase, zigzag position, place of the
//   block in the schedule's period P); a peek depends on the bit position
//   only, so decoding from a state reads exactly what the sequential lane
//   reads there.
//   1. Sync: thread u decodes from state (u·U, DC, 0, place 0) — a guess —
//      up to the first symbol boundary at or past (u+1)·U, its exit state,
//      counting the blocks whose DC symbol starts inside the subsequence
//      and their DC differences per component. Then, round after round,
//      each subsequence whose entry (its predecessor's exit) changed is
//      decoded again from it, until no exit changes. Subsequence 0 starts
//      from the true state, so the fixed point is the sequential decode;
//      the worst case is one subsequence a round, a sequential walk.
//      P consecutive blocks that consume no bits repeat forever (a failed
//      DC match reads nothing and a failed AC match is an EOB): such a
//      subsequence owns every later block, and the ones after it none.
//   2. Scan: exclusive prefix sums over the row's subsequences of the
//      block counts (saturating at B) and the DC sums (int32, wrapping —
//      the plain version's int64 sum cast to int32) give each
//      subsequence's first block index and DC predictors.
//   3. Write: each thread decodes the blocks whose DC symbol starts in its
//      subsequence (past its end if need be; the last subsequence is open)
//      into an int16 shared buffer and writes each whole as sixteen 16-byte
//      stores; the CTA writes blocks [seg_blocks[s], B) as zeros. Every
//      output byte is written once, with no zeroing pass.
//   The subsequences stop a little past the row's last nonzero byte; the
//   last one takes whatever the chain decodes beyond it (the zero padding,
//   past the row). Symbols go through the direct-lookup table
//   (huffman_decode_lut.cuh); the bit cursor reads aligned 32-bit words.

#include "huffman_decode_lut.cuh"

namespace {

using namespace vct;

constexpr int kThreads = 64;  // a row's (one CTA)
constexpr int kWarps = kThreads / 32;
// how far before its subsequence round 0's guessed decode begins
constexpr int kWarmBits = 1024;
constexpr unsigned long long kNever = 0x7FFFFFFFull << 32;
// per-row stats: sync rounds, subsequences, threads
constexpr int kStats = 3;
// Rows of up to this many bytes are copied into shared memory first: the
// lanes of a warp refill their bit windows at different symbols, and a
// refill from global memory would hold the whole warp for its latency
constexpr int kRowStage = 16384;

__host__ __device__ inline int staged_row_bytes(int L) {
  return L <= kRowStage ? (L + 15) / 16 * 16 + 16 : 0;  // zero slack after
}

// Row bytes as big-endian 32-bit words, zero past the row: from the staged
// copy in shared memory (words of bytes >= L are zero there) or from
// global memory.
struct RowWords {
  const uint8_t* row;
  int L;
  bool aligned;            // row start 4-byte aligned
  const uint32_t* staged;  // the staged copy, or null
  int staged_words;
  __device__ uint32_t word(int j) const {
    if (staged != nullptr)
      return j >= 0 && j < staged_words ? bswap32(staged[j]) : 0u;
    const int q = 4 * j;
    if (aligned && q >= 0 && q + 3 < L)
      return bswap32(__ldg(reinterpret_cast<const uint32_t*>(row) + j));
    uint32_t x = 0;
    for (int i = 0; i < 4; ++i)
      x = (x << 8) | (q + i >= 0 && q + i < L ? (uint32_t)row[q + i] : 0u);
    return x;
  }
};

// peek16 of the reference's stride-16 windows (K5's PaddedReader with
// 2-byte windows): below bit 16·NW the row's own bits, from there on the
// last window's bits at offset bit % 16, or zero when the window array was
// padded (tail_word = 0).
struct RowReader {
  BitWindow<RowWords> win;
  int tail_lim;
  uint32_t tail_word;
  __device__ int peek16(int p) {
    if (p >= tail_lim) return (int)((tail_word >> (16 - (p & 15))) & 0xFFFF);
    return win.peek16(p);
  }
};

__device__ inline unsigned long long pack(int bitpos, bool in_ac, int cof,
                                          int place) {
  return ((unsigned long long)(unsigned)bitpos << 32) |
         ((unsigned long long)place << 8) | (unsigned)(cof << 1) |
         (unsigned)in_ac;
}

struct Row {
  RowReader rd;
  Tables tb;
  Lut lut;
  const uint8_t* staged;  // components of the first places, in shared memory
  const int32_t* sched;
  int C, P, B;
  __device__ int comp(int place) const {
    return sched_comp(staged, sched, place, C);
  }
  __device__ int next(int place) const { return place + 1 == P ? 0 : place + 1; }
};

// Pass 1 for one subsequence: from entry state e up to the first symbol
// boundary at or past bit `end`. Returns the exit state; `cnt` and `dcs`
// get the blocks whose DC symbol starts before `end` and their DC sums.
__device__ unsigned long long sync_sub(Row& r, unsigned long long e, int end,
                                       int& cnt, int (&dcs)[kMaxComponents]) {
  cnt = 0;
#pragma unroll
  for (int c = 0; c < kMaxComponents; ++c) dcs[c] = 0;
  if (e == kNever) return kNever;
  int bitpos = (int)(e >> 32);
  int place = (int)((e >> 8) & 0xFFFFFF);
  int cof = (int)((e >> 1) & 0x7F);
  bool in_ac = e & 1;
  int comp = r.comp(place);
  int zstart = -1, zrun = 0;
  while (bitpos < end) {
    if (!in_ac) {
      // P blocks in a row that consumed no bits: the state repeats forever
      if (bitpos == zstart) {
        if (++zrun >= r.P) {
          cnt = r.B;
          return kNever;
        }
      } else {
        zstart = bitpos;
        zrun = 0;
      }
    }
    int used, run, cat, val;
    decode_symbol(r.rd, r.tb, r.lut, comp + (in_ac ? r.C : 0), in_ac, bitpos,
                  used, run, cat, val);
    bitpos += used;
    if (!in_ac) {
      ++cnt;
      add_dc(dcs, comp, val);
      in_ac = true;
      cof = 1;
    } else if ((run == 0 && cat == 0) || cof + run + 1 >= 64) {
      in_ac = false;
      cof = 0;
      place = r.next(place);
      comp = r.comp(place);
    } else {
      cof += run + 1;
    }
  }
  return pack(bitpos, in_ac, cof, place);
}

// Pass 3 for one subsequence: finish the block that an earlier subsequence
// owns, then decode and write blocks blk.. while their DC symbol starts
// before `end` and blk < nblk.
__device__ void write_sub(Row& r, unsigned long long e, int end, int blk,
                          int (&dc)[kMaxComponents], int nblk, BlockBuf& bb,
                          int32_t* dst) {
  if (e == kNever || blk >= nblk) return;
  int bitpos = (int)(e >> 32);
  int place = (int)((e >> 8) & 0xFFFFFF);
  int cof = (int)((e >> 1) & 0x7F);
  bool in_ac = e & 1;
  int comp = r.comp(place);
  int used, run, cat, val;
  while (in_ac) {
    decode_symbol(r.rd, r.tb, r.lut, comp + r.C, true, bitpos, used, run,
                  cat, val);
    bitpos += used;
    if ((run == 0 && cat == 0) || cof + run + 1 >= 64) {
      in_ac = false;
      place = r.next(place);
      comp = r.comp(place);
    } else {
      cof += run + 1;
    }
  }
  while (blk < nblk && bitpos < end) {
    decode_symbol(r.rd, r.tb, r.lut, comp, false, bitpos, used, run, cat,
                  val);
    bitpos += used;
    const int dcw = add_dc(dc, comp, val);
    cof = 1;
    for (;;) {
      decode_symbol(r.rd, r.tb, r.lut, comp + r.C, true, bitpos, used, run,
                    cat, val);
      bitpos += used;
      if (run == 0 && cat == 0) break;  // EOB
      const int nc = cof + run;
      if (nc < 64 && val) bb.put(nc, val);
      if (nc + 1 >= 64) break;
      cof = nc + 1;
    }
    bb.flush(dst + (size_t)blk * 64, dcw);
    ++blk;
    place = r.next(place);
    comp = r.comp(place);
  }
}

// (kThreads, 8): the register cap of 128 a thread that the kernel was tuned
// with
__global__ void __launch_bounds__(kThreads, 8) huffman_decode_streamed_kernel(
    const uint8_t* __restrict__ segbytes, int L, int NW, int NWp, int U,
    int n_sub_max, const int32_t* __restrict__ seg_blocks,
    const int32_t* __restrict__ comp_sched, int B, int C,
    const int32_t* __restrict__ lo_g, const int32_t* __restrict__ hi_g,
    const int32_t* __restrict__ off_g, int T,
    const int32_t* __restrict__ values_g, int V,
    const int16_t* __restrict__ lut_g, unsigned long long* rec_entry,
    unsigned long long* rec_exit, int* rec_cnt, int* rec_dc,
    int32_t* __restrict__ stats, int32_t* __restrict__ out) {
  extern __shared__ int4 smem4[];
  __shared__ int s_int;
  __shared__ int s_tot[kWarps][kMaxComponents + 1];
  __shared__ uint8_t s_comp[kSchedStage];
  int32_t* smem = reinterpret_cast<int32_t*>(smem4);
  Lut lut;
  stage_sched(s_comp, comp_sched, B, C);
  const Tables tb =
      stage_tables_lut(smem, lo_g, hi_g, off_g, T, values_g, V, lut_g, lut);
  const int tid = threadIdx.x, nthreads = kThreads;
  const int lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.x;
  const uint8_t* rowp = segbytes + (size_t)row * L;
  const int nblk = min(max(seg_blocks[row], 0), B);
  int32_t* dst = out + (size_t)row * B * 64;

  int* st = stats + (size_t)row * kStats;
  if (tid == 0) {
    st[0] = st[1] = 0;
    st[2] = nthreads;
  }

  // blocks at or past seg_blocks[s] are zeros
  {
    int4* z = reinterpret_cast<int4*>(dst + (size_t)nblk * 64);
    for (int i = tid; i < (B - nblk) * 16; i += nthreads)
      z[i] = make_int4(0, 0, 0, 0);
  }
  if (nblk == 0) return;

  // the schedule's smallest period P (sched[i] == sched[i + P] for all i)
  if (tid == 0) s_int = -1;
  __syncthreads();
  int P = B;
  for (int p = 1; p < B; ++p) {
    bool bad = false;
    for (int i = tid; i + p < B && !bad; i += nthreads)
      bad = sched_comp(s_comp, comp_sched, i, C) !=
            sched_comp(s_comp, comp_sched, i + p, C);
    if (!__syncthreads_or(bad)) {
      P = p;
      break;
    }
  }

  // stage the row (zero-padded) while finding its last nonzero byte,
  // which bounds the subsequences
  const int staged_bytes = staged_row_bytes(L);
  uint8_t* srow = reinterpret_cast<uint8_t*>(smem) + lut_smem_bytes(T, V) +
                  (size_t)nthreads * kBufHalves * sizeof(int16_t);
  int last = -1;
  if (((size_t)rowp & 15) == 0) {
    const int4* v = reinterpret_cast<const int4*>(rowp);
    for (int i = tid; i < L / 16; i += nthreads) {
      const int4 x = __ldg(v + i);
      if (x.x | x.y | x.z | x.w) last = 16 * i + 15;
      if (staged_bytes) reinterpret_cast<int4*>(srow)[i] = x;
    }
    for (int q = L / 16 * 16 + tid; q < staged_bytes; q += nthreads)
      srow[q] = q < L ? rowp[q] : 0;
    for (int q = L / 16 * 16 + tid; q < L; q += nthreads)
      if (rowp[q]) last = q;
  } else {
    for (int q = tid; q < max(L, staged_bytes); q += nthreads) {
      const uint8_t b = q < L ? rowp[q] : 0;
      if (b) last = q;
      if (q < staged_bytes) srow[q] = b;
    }
  }
  for (int o = 16; o; o >>= 1) last = max(last, __shfl_xor_sync(~0u, last, o));
  if (lane == 0) atomicMax(&s_int, last);
  __syncthreads();
  const int n_sub =
      min(max((8 * min(s_int + 1, L) + 32 + U - 1) / U, 1), n_sub_max);
  // each thread takes a run of consecutive subsequences, so a round
  // carries a corrected state through all of them
  const int per = (n_sub + nthreads - 1) / nthreads;
  const int u0 = min(tid * per, n_sub), u1 = min(u0 + per, n_sub);

  uint32_t tail_word = 0;
  if (NWp == NW) {
    const uint8_t* b = rowp + 2 * (NW - 1);
    tail_word = ((uint32_t)b[0] << 24) | ((uint32_t)b[1] << 16) |
                ((uint32_t)b[2] << 8) | (uint32_t)b[3];
  }
  Row r{RowReader{{RowWords{rowp, L, ((size_t)rowp & 3) == 0,
                            staged_bytes
                                ? reinterpret_cast<const uint32_t*>(srow)
                                : nullptr,
                            staged_bytes / 4}},
                  16 * NW, tail_word},
        tb, lut, s_comp, comp_sched, C, P, B};
  const size_t rb = (size_t)row * n_sub_max;
  volatile unsigned long long* v_exit = rec_exit + rb;
  unsigned long long* entry = rec_entry + rb;
  int* cnt = rec_cnt + rb;
  int* dcs = rec_dc + rb * kMaxComponents;

  // 1. sync: round 0 from guessed entries, then rounds until no exit moves
  for (int u = u0; u < u1; ++u) {
    int c = 0, d[kMaxComponents] = {0, 0, 0, 0};
    unsigned long long e = u == 0 ? 0ull : pack(u * U, false, 0, 0);
    if (u > 0) {
      // a better guess: the state at u·U of a decode begun kWarmBits
      // earlier from the same guess (or from the true start)
      int c_, d_[kMaxComponents];
      const int b0 = max(u * U - kWarmBits, 0);
      const unsigned long long g =
          sync_sub(r, b0 == 0 ? 0ull : pack(b0, false, 0, 0), u * U, c_, d_);
      if (g != kNever) e = g;
    }
    unsigned long long x = 0;
    if (u < n_sub - 1) x = sync_sub(r, e, (u + 1) * U, c, d);
    entry[u] = e;
    v_exit[u] = x;
    cnt[u] = c;
    for (int k = 0; k < kMaxComponents; ++k) dcs[u * kMaxComponents + k] = d[k];
  }
  int rounds = 1;
  for (;;) {
    __syncthreads();
    ++rounds;
    bool changed = false;
    for (int u = max(u0, 1); u < min(u1, n_sub - 1); ++u) {
      const unsigned long long e = v_exit[u - 1];
      if (e == entry[u]) continue;
      int c, d[kMaxComponents];
      const unsigned long long x = sync_sub(r, e, (u + 1) * U, c, d);
      entry[u] = e;
      changed |= x != v_exit[u];
      v_exit[u] = x;
      cnt[u] = c;
      for (int k = 0; k < kMaxComponents; ++k)
        dcs[u * kMaxComponents + k] = d[k];
    }
    if (!__syncthreads_or(changed)) break;
  }

  // 2. exclusive prefix of block counts (saturating at B) and DC sums
  int carry[kMaxComponents + 1] = {0, 0, 0, 0, 0};
  for (int base = 0; base < n_sub; base += nthreads) {
    const int u = base + tid;
    int v[kMaxComponents + 1] = {0, 0, 0, 0, 0};
    if (u < n_sub) {
      v[0] = min(cnt[u], B);
      for (int k = 0; k < kMaxComponents; ++k)
        v[k + 1] = dcs[u * kMaxComponents + k];
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
      for (int k = 0; k <= kMaxComponents; ++k) {
        const int w = __shfl_up_sync(~0u, v[k], o);
        if (lane >= o)
          v[k] = k ? (int)((unsigned)v[k] + (unsigned)w) : min(v[k] + w, B);
      }
    }
    if (lane == 31)
      for (int k = 0; k <= kMaxComponents; ++k) s_tot[warp][k] = v[k];
    __syncthreads();
#pragma unroll
    for (int k = 0; k <= kMaxComponents; ++k) {
      int excl = __shfl_up_sync(~0u, v[k], 1);
      if (lane == 0) excl = 0;
      int add = carry[k], tot = carry[k];
      for (int w = 0; w < nthreads / 32; ++w) {
        const int t = s_tot[w][k];
        if (w < warp)
          add = k ? (int)((unsigned)add + (unsigned)t) : min(add + t, B);
        tot = k ? (int)((unsigned)tot + (unsigned)t) : min(tot + t, B);
      }
      v[k] = k ? (int)((unsigned)add + (unsigned)excl) : min(add + excl, B);
      carry[k] = tot;
    }
    if (u < n_sub) {
      cnt[u] = v[0];
      for (int k = 0; k < kMaxComponents; ++k)
        dcs[u * kMaxComponents + k] = v[k + 1];
    }
    __syncthreads();
  }

  // 3. write: each subsequence's blocks, whole
  BlockBuf bb{reinterpret_cast<int16_t*>(reinterpret_cast<char*>(smem) +
                                         lut_smem_bytes(T, V)) +
              tid * kBufHalves};
  bb.clear();
  for (int u = u0; u < u1; ++u) {
    int dc[kMaxComponents];
    for (int k = 0; k < kMaxComponents; ++k)
      dc[k] = dcs[u * kMaxComponents + k];
    write_sub(r, u == 0 ? 0ull : v_exit[u - 1],
              u == n_sub - 1 ? INT_MAX : (u + 1) * U, cnt[u], dc, nblk, bb,
              dst);
  }
  if (tid == 0) {
    st[0] = rounds;
    st[1] = n_sub;
  }
}

}  // namespace

// lut: lut_entries(T) int16, where the lookup table is built first;
// sub_bits: U; scratch: S · n_sub_max · 40 bytes (entry and exit states,
// block counts, DC sums); stats: (S, kStats) int32.
extern "C" int vct_k6_huffman_decode_streamed(
    const uint8_t* segbytes, int S, int L, const int32_t* seg_blocks,
    const int32_t* comp_sched, int B, int C, const int32_t* lo,
    const int32_t* hi, const int32_t* offset, int T, const int32_t* values,
    int V, int16_t* lut, int sub_bits, int n_sub_max, void* scratch,
    int32_t* stats, int32_t* out, void* stream) {
  if (S <= 0) return (int)cudaGetLastError();
  const int err = vct_huffman_lut(lo, hi, offset, T, values, V,
                                  lut, stream);
  if (err != 0) return err;
  const int NW = (L - 2) / 2 > 1 ? (L - 2) / 2 : 1;
  const int NWp = (NW + 7) / 8 * 8;
  const size_t n = (size_t)S * n_sub_max;
  auto* rec_entry = static_cast<unsigned long long*>(scratch);
  auto* rec_exit = rec_entry + n;
  auto* rec_cnt = reinterpret_cast<int*>(rec_exit + n);
  auto* rec_dc = rec_cnt + n;
  const size_t smem = lut_smem_bytes(T, V) +
                      (size_t)kThreads * kBufHalves * sizeof(int16_t) +
                      staged_row_bytes(L);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(huffman_decode_streamed_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  // as many CTAs an SM as shared memory allows: the lookup table and the
  // block buffers, not the L1 cache, bound how many fit
  cudaFuncSetAttribute(huffman_decode_streamed_kernel,
                       cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  huffman_decode_streamed_kernel<<<S, kThreads, smem, (cudaStream_t)stream>>>(
      segbytes, L, NW, NWp, sub_bits, n_sub_max, seg_blocks, comp_sched, B,
      C, lo, hi, offset, T, values, V, lut, rec_entry, rec_exit, rec_cnt,
      rec_dc, stats, out);
  return (int)cudaGetLastError();
}
