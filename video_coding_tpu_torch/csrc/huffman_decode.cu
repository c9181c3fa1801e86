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
//   (code match → magnitude → DC/AC update), ~65 dependent steps per
//   block; 130,560 lanes at the main path's shape is ~1000 lanes per SM,
//   so the kernel is latency-bound, not bandwidth-bound (the compressed
//   input is ~3 MB a dispatch; the coefficient output is written sparsely).
//
// What the design does about it: the TPU kernel's one-hot reductions,
//   stride-16 peek windows and int16-packed carries exist only because
//   Mosaic has no per-lane gathers; here each thread keeps a 64-bit bit
//   buffer in registers refilled byte by byte from global memory, the
//   range tables and values sit in shared memory, the DC predictors in
//   registers, and only nonzero coefficients are stored (the wrapper
//   zeroes the output). Enough lanes are in flight per SM to hide the
//   dependent-load latency of the byte refills.

#include "huffman_decode_common.cuh"

namespace {

using namespace vct;

struct GlobalFetch {
  const uint8_t* src;
  int len;
  __device__ uint64_t operator()(int p) const {
    return p < len ? (uint64_t)src[p] : 0ull;
  }
};

__global__ void huffman_decode_kernel(
    const uint8_t* __restrict__ flat, const int32_t* __restrict__ starts,
    const int32_t* __restrict__ lens, const int32_t* __restrict__ seg_blocks,
    int S, const int32_t* __restrict__ comp_sched, int B, int C,
    const int32_t* __restrict__ lo_g, const int32_t* __restrict__ hi_g,
    const int32_t* __restrict__ off_g, int T,
    const int32_t* __restrict__ values_g, int V, int max_steps,
    const int32_t* __restrict__ init_bitpos,
    const int32_t* __restrict__ init_dc, int32_t* __restrict__ out) {
  extern __shared__ int32_t smem[];
  const Tables tb = stage_tables(smem, lo_g, hi_g, off_g, T, values_g, V);

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= S) return;
  GlobalFetch fetch{flat + starts[lane], lens[lane]};
  decode_lane_stream(fetch, tb, comp_sched, min(seg_blocks[lane], B), C,
                     max_steps, init_bitpos ? init_bitpos[lane] : 0,
                     init_dc ? init_dc + (size_t)lane * C : nullptr,
                     out + (size_t)lane * B * 64);
}

}  // namespace

// init_bitpos (S,) and init_dc (S, C) may be null: no start-state hooks.
extern "C" int vct_k1_huffman_decode(
    const uint8_t* flat, const int32_t* starts, const int32_t* lens,
    const int32_t* seg_blocks, int S, const int32_t* comp_sched, int B,
    int C, const int32_t* lo, const int32_t* hi, const int32_t* offset,
    int T, const int32_t* values, int V, int max_steps,
    const int32_t* init_bitpos, const int32_t* init_dc, int32_t* out,
    void* stream) {
  if (S <= 0) return (int)cudaGetLastError();
  const int threads = 128;
  const int blocks = (S + threads - 1) / threads;
  const size_t smem = table_ints(T, V) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(huffman_decode_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  huffman_decode_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      flat, starts, lens, seg_blocks, S, comp_sched, B, C, lo, hi, offset,
      T, values, V, max_steps, init_bitpos, init_dc, out);
  return (int)cudaGetLastError();
}
