// K6 — streamed Huffman decode of long segments, one thread per row.
//
// Replaces: video_coding_tpu/entropy/pallas_decode.py _kernel_bs (the
//   pallas_call in decode_segments_pallas_bs). Same contract: row s of the
//   (S, L) uint8 matrix decodes into (S, B, 64) int32 zigzag coefficients,
//   the block's component taken from the periodic schedule, DC prediction
//   from zero, values NOT saturated, blocks at or past seg_blocks[s]
//   written as zeros, and a cap of 134 symbols a BLOCK: a block that
//   reaches it is left as it stands and the next starts afresh at the bit
//   cursor where it stopped. Peeks read the reference's stride-16 windows
//   (see WindowReader).
//
// What the TPU kernel is for: a segment of hundreds of blocks (one MCU row
//   of a 1080p frame is 720) cannot keep its whole coefficient block on
//   chip, so it keeps ONE block per lane and streams finished blocks out.
//
// What bounds it on an H100: the output — (S, B, 64) int32 is ~200 MB for
//   16 frames — against few, long, serial lanes (about a thousand a
//   dispatch), so the kernel is latency-bound far below the byte bound.
//
// What the design does about it: the 64-coefficient block buffer of a lane
//   lives in shared memory (row stride 68 words, so the lanes' 16-byte
//   reads and writes spread over the banks); a finished block leaves as
//   sixteen 16-byte stores, so the output needs no zeroing pass and takes
//   no scattered 4-byte stores; the segment's bytes come through an 8-byte
//   register window refilled as the cursor moves, never held whole. CTAs
//   are 8 threads: the ~1,000 lanes of a dispatch then cover all SMs, and
//   only 8 lanes share a warp's instruction stream. The reference's
//   block-synchronized lanes, window slabs and grid-carried scratch are
//   the TPU's sequential grid at work and are not kept: lanes run free.

#include "huffman_decode_common.cuh"

namespace {

using namespace vct;

constexpr int kThreads = 8;
constexpr int kBufStride = 68;  // int32 words per lane, 16-byte aligned

struct BlockSink {
  int32_t* buf;  // the lane's 64-coefficient buffer in shared memory
  int32_t* dst;  // the lane's (B, 64) slot of the output
  __device__ void begin(int) {
    int4* b = reinterpret_cast<int4*>(buf);
#pragma unroll
    for (int i = 0; i < 16; ++i) b[i] = make_int4(0, 0, 0, 0);
  }
  __device__ void put(int cof, int v) { buf[cof] = v; }
  __device__ void end(int blk) {
    const int4* b = reinterpret_cast<const int4*>(buf);
    int4* o = reinterpret_cast<int4*>(dst + (size_t)blk * 64);
#pragma unroll
    for (int i = 0; i < 16; ++i) o[i] = b[i];
  }
};

__global__ void huffman_decode_streamed_kernel(
    const uint8_t* __restrict__ segbytes, int L, int NW, int NWp,
    const int32_t* __restrict__ seg_blocks, int S,
    const int32_t* __restrict__ comp_sched, int B, int C,
    const int32_t* __restrict__ lo_g, const int32_t* __restrict__ hi_g,
    const int32_t* __restrict__ off_g, int T,
    const int32_t* __restrict__ values_g, int V, int block_cap,
    int32_t* __restrict__ out) {
  extern __shared__ int32_t smem[];
  const Tables tb = stage_tables(smem, lo_g, hi_g, off_g, T, values_g, V);

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= S) return;
  const int nblk = min(max(seg_blocks[lane], 0), B);
  WindowReader rd{segbytes + (size_t)lane * L, L, 4, NW, NWp};
  BlockSink sink{smem + table_ints(T, V) + threadIdx.x * kBufStride,
                 out + (size_t)lane * B * 64};
  decode_lane_windows(rd, tb, comp_sched, nblk, C, INT_MAX, block_cap, sink);
  for (int blk = nblk; blk < B; ++blk) {
    sink.begin(blk);
    sink.end(blk);
  }
}

}  // namespace

extern "C" int vct_k6_huffman_decode_streamed(
    const uint8_t* segbytes, int S, int L, const int32_t* seg_blocks,
    const int32_t* comp_sched, int B, int C, const int32_t* lo,
    const int32_t* hi, const int32_t* offset, int T, const int32_t* values,
    int V, int block_cap, int32_t* out, void* stream) {
  if (S <= 0) return (int)cudaGetLastError();
  const int NW = (L - 2) / 2 > 1 ? (L - 2) / 2 : 1;
  const int NWp = (NW + 7) / 8 * 8;
  const int blocks = (S + kThreads - 1) / kThreads;
  const size_t smem =
      (table_ints(T, V) + (size_t)kThreads * kBufStride) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(huffman_decode_streamed_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  huffman_decode_streamed_kernel<<<blocks, kThreads, smem,
                                   (cudaStream_t)stream>>>(
      segbytes, L, NW, NWp, seg_blocks, S, comp_sched, B, C, lo, hi, offset,
      T, values, V, block_cap, out);
  return (int)cudaGetLastError();
}
