// K7 — K1 fed by asynchronous copies into shared memory that the kernel
// starts itself, one thread per segment.
//
// Replaces: video_coding_tpu/entropy/pallas_decode.py _kernel_t_dma (the
//   pallas_call in decode_flat_pallas_dma). Same contract as K1, start-state
//   hooks included, and the same result bit for bit: the lane's bytes are
//   taken as 16-byte rows from the 16-byte-aligned row starts[s] >> 4 of
//   the flat buffer, the <= 15 bytes of slack before the segment ride the
//   initial bit cursor and the effective length, bytes at or past the
//   effective length read as zero (a row outside the buffer reads its
//   nearest byte, as K1 and the plain version's clamped gather do), then
//   K1's symbol loop runs on the copy.
//
// What bounds it on an H100: as K1, latency of a serial automaton per lane;
//   the copies move the ~3 MB of compressed input once, the (S, B, 64)
//   int32 output is ~200 MB at the main path's shape.
//
// What the design does about it: the lane loop is K1's (decode_lane_lut:
//   the two-level lookup table built by huffman_lut.cu each call, a 64-bit
//   window of aligned big-endian words, whole-block int16 buffers that
//   leave as 16-byte stores, zero blocks past the lane's end — so the
//   output needs no zeroing pass); only the word source differs. The
//   counterpart of the TPU kernel's per-lane DMA is cp.async (16 bytes,
//   global → shared, no registers in between) into a per-thread ring of
//   two halves of kHalfRows rows. The window asks for words in order, one
//   step ahead; when it first asks for a word in the ring's second half,
//   that half is waited for and the next half is started into the first,
//   which no later word needs — so a lane of any length streams through
//   the ring with its copies a half ahead of the cursor. Each thread waits
//   only for its own copies, so no CTA barrier is needed; slots are
//   interleaved (row slot r of thread t at r·threads + t), so a warp's
//   copies and reads are neighbours. An aligned word never straddles a
//   16-byte row.

#include "huffman_decode_lut.cuh"

namespace {

using namespace vct;

constexpr int kThreads = 128;      // a CTA's (one lane each)
constexpr int kHalfRowsLog = 1;
constexpr int kHalfRows = 1 << kHalfRowsLog;  // 16-byte rows a half-ring
constexpr int kRingRows = 2 * kHalfRows;

__device__ inline void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem_src)
               : "memory");
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Aligned big-endian 32-bit word j of a lane (bytes 4j..4j+3 from its
// first row), zero from the effective length on, served from the ring.
struct StagedWords {
  const uint8_t* flat;  // 16-byte aligned
  long long n_rows;     // 16-byte rows in flat
  long long row0;       // the lane's first row
  int len_eff;          // slack + segment length, in bytes from row0
  uint8_t* ring;        // the CTA's ring buffer
  int issued = INT_MIN / 2;  // halves [issued - 2, issued) are in the ring
  int waited = INT_MIN / 2;  // halves below this have landed

  __device__ uint8_t* slot(int r) const {
    return ring + ((size_t)(r & (kRingRows - 1)) * blockDim.x + threadIdx.x) *
                      16;
  }

  // start the copies of half h (rows past the lane's end are skipped,
  // rows outside the buffer filled with its nearest byte) as one group
  __device__ void issue(int h) {
#pragma unroll
    for (int i = 0; i < kHalfRows; ++i) {
      const int r = h * kHalfRows + i;
      if (r * 16 >= len_eff) break;
      const long long row = row0 + r;
      if (row >= 0 && row < n_rows) {
        cp_async16(slot(r), flat + row * 16);
      } else {
        const uint32_t b =
            n_rows > 0 ? flat[row < 0 ? 0 : n_rows * 16 - 1] : 0u;
        const uint32_t w = b * 0x01010101u;
        *reinterpret_cast<uint4*>(slot(r)) = make_uint4(w, w, w, w);
      }
    }
    cp_async_commit();
  }

  __device__ uint32_t word(int j) {
    const int q = 4 * j;
    const int keep = len_eff - q;  // bytes of this word inside the lane
    if (keep <= 0) return 0;
    const int h = (q >> 4) >> kHalfRowsLog;
    if (h >= issued || h < issued - 2) {  // not in the ring: start here
      cp_async_wait<0>();
      issue(h);
      issue(h + 1);
      issued = h + 2;
      cp_async_wait<1>();
      waited = h + 1;
    } else if (h >= waited) {  // the half copied ahead: wait, copy the next
      cp_async_wait<0>();
      waited = issued;
      issue(issued++);
    }
    const uint32_t x =
        bswap32(*reinterpret_cast<const uint32_t*>(slot(q >> 4) + (q & 15)));
    return keep >= 4 ? x : x & ~(0xFFFFFFFFu >> (8 * keep));
  }
};

__global__ void __launch_bounds__(kThreads) huffman_decode_staged_kernel(
    const uint8_t* __restrict__ flat, long long n_rows,
    const int32_t* __restrict__ starts, const int32_t* __restrict__ lens,
    const int32_t* __restrict__ seg_blocks, int S,
    const int32_t* __restrict__ comp_sched, int B, int C,
    const int32_t* __restrict__ lo_g, const int32_t* __restrict__ hi_g,
    const int32_t* __restrict__ off_g, int T,
    const int32_t* __restrict__ values_g, int V,
    const int16_t* __restrict__ lut_g, int max_steps,
    const int32_t* __restrict__ init_bitpos,
    const int32_t* __restrict__ init_dc, int32_t* __restrict__ out) {
  extern __shared__ int4 smem4[];
  __shared__ uint8_t s_comp[kSchedStage];
  int32_t* smem = reinterpret_cast<int32_t*>(smem4);
  Lut lut;
  stage_sched(s_comp, comp_sched, B, C);
  const Tables tb =
      stage_tables_lut(smem, lo_g, hi_g, off_g, T, values_g, V, lut_g, lut);

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= S) return;
  char* bufs = reinterpret_cast<char*>(smem) + lut_smem_bytes(T, V);
  BlockBuf bb{reinterpret_cast<int16_t*>(bufs) + threadIdx.x * kBufHalves};
  bb.clear();
  GlobalBlocks sink{bb, out + (size_t)lane * B * 64};
  const int start = starts[lane];
  const int slack = start & 15;
  BitWindow<StagedWords> rd{StagedWords{
      flat, n_rows, start >> 4, lens[lane] + slack,
      reinterpret_cast<uint8_t*>(bufs) +
          (size_t)blockDim.x * kBufHalves * sizeof(int16_t)}};
  decode_lane_lut<true>(rd, tb, lut, s_comp, comp_sched,
                        min(seg_blocks[lane], B), B, C, max_steps,
                        8 * slack + (init_bitpos ? init_bitpos[lane] : 0),
                        init_dc ? init_dc + (size_t)lane * C : nullptr,
                        sink);
  cp_async_wait<0>();  // no copy outlives its thread
}

}  // namespace

// flat must be 16-byte aligned and flat_len a multiple of 16. lut:
// lut_entries(T) int16, where the lookup table is built first.
// init_bitpos (S,) and init_dc (S, C) may be null.
extern "C" int vct_k7_huffman_decode_staged(
    const uint8_t* flat, long long flat_len, const int32_t* starts,
    const int32_t* lens, const int32_t* seg_blocks, int S,
    const int32_t* comp_sched, int B, int C, const int32_t* lo,
    const int32_t* hi, const int32_t* offset, int T, const int32_t* values,
    int V, int16_t* lut, int max_steps, const int32_t* init_bitpos,
    const int32_t* init_dc, int32_t* out, void* stream) {
  if (S <= 0) return (int)cudaGetLastError();
  const int err = vct_huffman_lut(lo, hi, offset, T, values, V, lut, stream);
  if (err != 0) return err;
  const int blocks = (S + kThreads - 1) / kThreads;
  const size_t smem = lut_smem_bytes(T, V) +
                      (size_t)kThreads * kBufHalves * sizeof(int16_t) +
                      (size_t)kThreads * kRingRows * 16;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(huffman_decode_staged_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  cudaFuncSetAttribute(huffman_decode_staged_kernel,
                       cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  huffman_decode_staged_kernel<<<blocks, kThreads, smem,
                                 (cudaStream_t)stream>>>(
      flat, flat_len / 16, starts, lens, seg_blocks, S, comp_sched, B, C, lo,
      hi, offset, T, values, V, lut, max_steps, init_bitpos, init_dc, out);
  return (int)cudaGetLastError();
}
