// K1 — canonical-Huffman decode of restart segments, one thread per segment.
//
// Replaces: video_coding_tpu/entropy/pallas_decode.py _kernel_t /
//   _symbol_loop_t (the pallas_call in _run_kernel_t), reached through
//   decode_flat_pallas_t. Same contract: every lane decodes one restart
//   segment of the flat destuffed buffer (bytes past the segment's length
//   read as zero) into (S, B, 64) int32 zigzag coefficients — DC
//   prediction per component, values saturated to int16, a step cap so a
//   corrupt stream terminates. With the start-state hooks a lane begins at
//   bit init_bitpos[s] of its byte range with the DC predictors
//   init_dc[s]: the virtual segments of a restart-free stream, whose last
//   byte may hold bits of the next lane — the block count ends such a
//   lane, not its length.
//
// What bounds it on an H100: it is a serial state machine per lane
//   (code match → magnitude → DC/AC update), ~17 dependent symbol steps a
//   block at q90; 130,560 lanes at the main path's shape is ~1000 lanes per
//   SM, so the kernel is latency-bound, not bandwidth-bound (the compressed
//   input is ~3 MB a dispatch, the (S, B, 64) int32 output 200 MB).
//
// What the design does about it: the TPU kernel's one-hot reductions,
//   stride-16 peek windows and int16-packed carries exist only because
//   Mosaic has no per-lane gathers. Here a symbol costs one lookup in a
//   2^10-entry table per table row in shared memory, and a code longer
//   than 10 bits one more in a level-2 block (huffman_lut.cu builds both
//   once a call; the 16-way range compare is left only for tables whose
//   long-code prefixes outnumber the blocks), the bit cursor reads a 64-bit
//   window refilled by one aligned 32-bit load every 32 bits, the DC
//   predictors stay in registers, and each finished block leaves from an
//   int16 shared buffer as sixteen 16-byte stores — blocks the lane does
//   not reach as zeros, so the output needs no zeroing pass.

#include "huffman_decode_lut.cuh"

namespace {

using namespace vct;

constexpr int kThreads = 256;  // a CTA's (one lane each)

// Byte q of a lane is flat[start + q] for q < len (an address outside the
// buffer reads its nearest byte, as the plain version's clamped gather
// does), zero from len on. Words are aligned 32-bit words of memory, so the
// buffer's own misalignment mis = flat & 3 shifts them: word j of the lane
// starts at flat[4·(w0 + j) - mis], and bit p of the lane is bit
// p + 8·((start + mis) & 3) of word 0.
struct FlatWords {
  const uint8_t* flat;
  long long flat_len;
  int mis;
  long long w0;   // (start + mis) / 4, rounded down
  long long end;  // start + len
  __device__ uint32_t word(int j) const {
    const long long a = 4 * (w0 + j) - mis;  // the word's first byte
    if (flat_len <= 0) return 0;
    uint32_t x;
    if (a >= 0 && a + 3 < flat_len) {
      x = bswap32(__ldg(reinterpret_cast<const uint32_t*>(flat + a)));
    } else {
      x = 0;
      for (int i = 0; i < 4; ++i)
        x = (x << 8) |
            (uint32_t)flat[min(max(a + i, 0ll), flat_len - 1)];
    }
    const long long keep = end - a;  // bytes of this word inside the lane
    if (keep >= 4) return x;
    if (keep <= 0) return 0;
    return x & ~(0xFFFFFFFFu >> (8 * keep));
  }
};

struct LaneReader {
  BitWindow<FlatWords> win;
  int off0;  // 8 · ((start + mis) & 3)
  __device__ int peek16(int p) { return win.peek16(off0 + p); }
};

__global__ void __launch_bounds__(kThreads) huffman_decode_kernel(
    const uint8_t* __restrict__ flat, long long flat_len,
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
  BlockBuf bb{reinterpret_cast<int16_t*>(
                  reinterpret_cast<char*>(smem) + lut_smem_bytes(T, V)) +
              threadIdx.x * kBufHalves};
  bb.clear();
  GlobalBlocks sink{bb, out + (size_t)lane * B * 64};
  const int mis = (int)(reinterpret_cast<uintptr_t>(flat) & 3);
  const long long start = (long long)starts[lane] + mis;
  LaneReader rd{{FlatWords{flat, flat_len, mis, start >> 2,
                           start - mis + lens[lane]}},
                8 * (int)(start & 3)};
  decode_lane_lut<true>(rd, tb, lut, s_comp, comp_sched,
                        min(seg_blocks[lane], B), B, C, max_steps,
                        init_bitpos ? init_bitpos[lane] : 0,
                        init_dc ? init_dc + (size_t)lane * C : nullptr,
                        sink);
}

}  // namespace

// lut: lut_entries(T) int16, where the lookup table is built first.
// init_bitpos (S,) and init_dc (S, C) may be null: no start-state hooks.
extern "C" int vct_k1_huffman_decode(
    const uint8_t* flat, long long flat_len, const int32_t* starts,
    const int32_t* lens, const int32_t* seg_blocks, int S,
    const int32_t* comp_sched, int B, int C, const int32_t* lo,
    const int32_t* hi, const int32_t* offset, int T, const int32_t* values,
    int V, int16_t* lut, int max_steps, const int32_t* init_bitpos,
    const int32_t* init_dc, int32_t* out, void* stream) {
  if (S <= 0) return (int)cudaGetLastError();
  const int err = vct_huffman_lut(lo, hi, offset, T, values, V,
                                  lut, stream);
  if (err != 0) return err;
  const int blocks = (S + kThreads - 1) / kThreads;
  const size_t smem =
      lut_smem_bytes(T, V) + (size_t)kThreads * kBufHalves * sizeof(int16_t);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(huffman_decode_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  // as many CTAs an SM as shared memory allows: the lookup table and the
  // block buffers, not the L1 cache, bound how many fit
  cudaFuncSetAttribute(huffman_decode_kernel,
                       cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  huffman_decode_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      flat, flat_len, starts, lens, seg_blocks, S, comp_sched, B, C, lo, hi,
      offset, T, values, V, lut, max_steps, init_bitpos, init_dc, out);
  return (int)cudaGetLastError();
}
