// K5 — Huffman decode of a padded lane matrix, one thread per row.
//
// Replaces: video_coding_tpu/entropy/pallas_decode.py _kernel (the
//   pallas_call in decode_segments_pallas). Same contract: row s of the
//   (S, L) uint8 matrix (a destuffed segment, zero-padded with >= 4 guard
//   bytes) decodes into seg_blocks[s] blocks of (S, B, 64) int32 zigzag
//   coefficients, DC prediction from zero, values NOT saturated, no
//   start-state hooks, a step cap a lane. Past the row a peek reads what
//   the reference's clamped, tile-padded window index reads (see
//   WindowReader), not K1's zeros.
//
// What bounds it on an H100: as K1, a serial automaton per lane and so
//   latency-bound; the input is S·L bytes, the output is written sparsely
//   into a zeroed tensor.
//
// What the design does about it: adjacent lanes' rows are contiguous, so a
//   CTA copies its rows into shared memory with coalesced 4-byte loads (row
//   stride L + 4 bytes, so the lanes' byte reads spread over the banks) and
//   every thread decodes from there through an 8-byte register window. Rows
//   too long for shared memory, or not 4-byte aligned, are read from global
//   memory directly. CTAs are one warp, so that the 8,160 lanes of a single
//   1080p frame spread over all SMs. The reference's sublane-major layout,
//   one-hot gathers and lane chunks are Mosaic's needs and are not kept.

#include "huffman_decode_common.cuh"

namespace {

using namespace vct;

constexpr int kThreads = 32;
constexpr size_t kStageLimit = 96 * 1024;

struct SparseSink {
  int32_t* dst;  // the lane's (B, 64) slot of the zeroed output
  int blk = 0;
  __device__ void begin(int b) { blk = b; }
  __device__ void put(int cof, int v) {
    if (v) dst[blk * 64 + cof] = v;
  }
  __device__ void end(int) {}
};

__global__ void huffman_decode_padded_kernel(
    const uint8_t* __restrict__ segbytes, int L, int NW, int NWp,
    const int32_t* __restrict__ seg_blocks, int S,
    const int32_t* __restrict__ comp_sched, int B, int C,
    const int32_t* __restrict__ lo_g, const int32_t* __restrict__ hi_g,
    const int32_t* __restrict__ off_g, int T,
    const int32_t* __restrict__ values_g, int V, int max_steps,
    int stage_stride, int32_t* __restrict__ out) {
  extern __shared__ int32_t smem[];
  const Tables tb = stage_tables(smem, lo_g, hi_g, off_g, T, values_g, V);

  const int lane0 = blockIdx.x * blockDim.x;
  const int lane = lane0 + threadIdx.x;
  const uint8_t* row = segbytes + (size_t)lane * L;
  if (stage_stride) {
    uint32_t* stage = reinterpret_cast<uint32_t*>(smem + table_ints(T, V));
    const uint32_t* src =
        reinterpret_cast<const uint32_t*>(segbytes + (size_t)lane0 * L);
    const int wpr = L / 4;
    const int n = min((int)blockDim.x, S - lane0) * wpr;
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      stage[(i / wpr) * (stage_stride / 4) + i % wpr] = src[i];
    __syncthreads();
    row = reinterpret_cast<const uint8_t*>(stage) +
          (size_t)threadIdx.x * stage_stride;
  }
  if (lane >= S) return;
  WindowReader rd{row, L, 3, NW, NWp};
  SparseSink sink{out + (size_t)lane * B * 64};
  decode_lane_windows(rd, tb, comp_sched, min(seg_blocks[lane], B), C,
                      max_steps, INT_MAX, sink);
}

}  // namespace

extern "C" int vct_k5_huffman_decode_padded(
    const uint8_t* segbytes, int S, int L, const int32_t* seg_blocks,
    const int32_t* comp_sched, int B, int C, const int32_t* lo,
    const int32_t* hi, const int32_t* offset, int T, const int32_t* values,
    int V, int max_steps, int32_t* out, void* stream) {
  if (S <= 0) return (int)cudaGetLastError();
  const int NW = L - 3;
  const int NWp = (NW + 127) / 128 * 128;
  const int blocks = (S + kThreads - 1) / kThreads;
  size_t smem = table_ints(T, V) * sizeof(int32_t);
  int stage_stride = 0;
  if (L % 4 == 0 && reinterpret_cast<uintptr_t>(segbytes) % 4 == 0 &&
      smem + (size_t)kThreads * (L + 4) <= kStageLimit) {
    stage_stride = L + 4;
    smem += (size_t)kThreads * stage_stride;
  }
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(huffman_decode_padded_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  huffman_decode_padded_kernel<<<blocks, kThreads, smem,
                                 (cudaStream_t)stream>>>(
      segbytes, L, NW, NWp, seg_blocks, S, comp_sched, B, C, lo, hi, offset,
      T, values, V, max_steps, stage_stride, out);
  return (int)cudaGetLastError();
}
