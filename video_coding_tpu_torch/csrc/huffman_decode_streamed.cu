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
//   (after Weißenberger & Schmidt, ICPP 2018; huffman_decode_sync.cuh,
//   shared with K5's "row" regime): the row's data is cut into
//   subsequences of U bits, one thread each at a time, synchronised in
//   rounds from guessed states, then an exclusive scan of their block
//   counts and DC sums, then each thread writes its subsequences' blocks
//   whole; the CTA writes blocks [seg_blocks[s], B) as zeros. Every output
//   byte is written once, with no zeroing pass. The subsequences stop a
//   little past the row's last nonzero byte; the last one takes whatever
//   the chain decodes beyond it (the zero padding, past the row). Symbols
//   go through the direct-lookup table (huffman_decode_lut.cuh); the bit
//   cursor reads aligned 32-bit words.

#include "huffman_decode_sync.cuh"

namespace {

using namespace vct;

constexpr int kThreads = 64;  // a row's (one CTA)
constexpr int kWarps = kThreads / 32;
// how far before its subsequence round 0's guessed decode begins
constexpr int kWarmBits = 1024;
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

using Row = SyncRow<RowReader>;

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
  const int lane = tid & 31;
  const int row = blockIdx.x;
  const uint8_t* rowp = segbytes + (size_t)row * L;
  const int nblk = min(max(seg_blocks[row], 0), B);
  int32_t* dst = out + (size_t)row * B * 64;

  int* st = stats + (size_t)row * kSyncStats;
  if (tid == 0) {
    st[0] = st[1] = 0;
    st[2] = nthreads;
  }

  // blocks at or past seg_blocks[s] are zeros
  zero_blocks_past(dst, nblk, B);
  if (nblk == 0) return;

  if (tid == 0) s_int = -1;
  __syncthreads();
  const int P = schedule_period(s_comp, comp_sched, B, C);

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
  // each thread takes a run of consecutive subsequences
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
  const SubRecords rec{rec_entry + rb, rec_exit + rb, rec_cnt + rb,
                       rec_dc + rb * kMaxComponents};

  const int rounds =
      sync_subsequences(r, U, kWarmBits, n_sub, u0, u1, rec);
  scan_subsequences<kThreads>(n_sub, B, rec, s_tot);
  BlockBuf bb{reinterpret_cast<int16_t*>(reinterpret_cast<char*>(smem) +
                                         lut_smem_bytes(T, V)) +
              tid * kBufHalves};
  bb.clear();
  write_subsequences(r, U, n_sub, u0, u1, nblk, rec, bb, dst);
  if (tid == 0) {
    st[0] = rounds;
    st[1] = n_sub;
  }
}

}  // namespace

// lut: lut_entries(T) int16, where the lookup table is built first;
// sub_bits: U; scratch: S · n_sub_max · 40 bytes (entry and exit states,
// block counts, DC sums); stats: (S, kSyncStats) int32.
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
