// K1 — canonical-Huffman decode of restart segments, one thread per segment.
//
// Replaces: video_coding_tpu/entropy/pallas_decode.py _kernel_t /
//   _symbol_loop_t (the pallas_call in _run_kernel_t), reached through
//   decode_flat_pallas_t. Same contract: every lane decodes one restart
//   segment of the flat destuffed buffer (bytes past the segment's length
//   read as zero) into (S, B, 64) int32 zigzag coefficients — DC
//   prediction per component, values saturated to int16, a step cap so a
//   corrupt stream terminates.
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

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxComponents = 4;

__global__ void huffman_decode_kernel(
    const uint8_t* __restrict__ flat, const int32_t* __restrict__ starts,
    const int32_t* __restrict__ lens, const int32_t* __restrict__ seg_blocks,
    int S, const int32_t* __restrict__ comp_sched, int B, int C,
    const int32_t* __restrict__ lo_g, const int32_t* __restrict__ hi_g,
    const int32_t* __restrict__ off_g, int T,
    const int32_t* __restrict__ values_g, int V, int max_steps,
    int32_t* __restrict__ out) {
  extern __shared__ int32_t smem[];
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

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= S) return;
  const uint8_t* src = flat + starts[lane];
  const int len = lens[lane];
  const int nblk = min(seg_blocks[lane], B);
  int32_t* dst = out + (size_t)lane * B * 64;

  // MSB-aligned bit buffer: the next `nb` stream bits are buf's top bits
  uint64_t buf = 0;
  int nb = 0;
  int p = 0;  // next byte to load
  int dc[kMaxComponents] = {0, 0, 0, 0};
  int blk = 0, cof = 0, steps = 0;
  bool in_ac = false;

  while (blk < nblk && steps < max_steps) {
    ++steps;
    while (nb <= 56) {
      const uint64_t byte = (p < len) ? (uint64_t)src[p] : 0ull;
      ++p;
      buf |= byte << (56 - nb);
      nb += 8;
    }
    const int w16 = (int)(buf >> 48);
    // schedule entries past the tables clamp to the last component (the
    // sessions never produce them)
    const int comp = min(max(__ldg(comp_sched + blk), 0), C - 1);
    const int t = comp + (in_ac ? C : 0);
    int code_len = 0, lo_sel = 0, off_sel = 0;
#pragma unroll
    for (int l = 0; l < 16; ++l) {
      if (w16 >= lo[t * 16 + l] && w16 < hi[t * 16 + l]) {
        code_len += l + 1;
        lo_sel += lo[t * 16 + l];
        off_sel += off[t * 16 + l];
      }
    }
    int data = 0;
    if (code_len > 0) {
      int idx = off_sel + ((w16 - lo_sel) >> (16 - min(code_len, 16)));
      idx = min(max(idx, 0), V - 1);
      data = values[idx] & 0xFF;
    }
    const int run = in_ac ? (data >> 4) & 0xF : 0;
    // baseline size categories are <= 11; 16 bounds the 32-bit window
    const int cat = min(in_ac ? (data & 0xF) : data, 16);
    int val = 0;
    if (cat > 0) {
      const int code = (int)((buf << code_len) >> (64 - cat));
      val = (code & (1 << (cat - 1))) ? code : code - (1 << cat) + 1;
    }
    const int used = code_len + cat;
    buf = used ? (buf << used) : buf;
    nb -= used;

    if (!in_ac) {
      dc[comp] += val;
      const int sat = min(max(dc[comp], -32768), 32767);
      if (sat) dst[blk * 64] = sat;
      in_ac = true;
      cof = 1;
    } else if (run == 0 && cat == 0) {  // EOB
      ++blk;
      in_ac = false;
      cof = 0;
    } else {
      const int nc = cof + run;
      if (nc < 64 && val) dst[blk * 64 + nc] = min(max(val, -32768), 32767);
      if (nc + 1 >= 64) {
        ++blk;
        in_ac = false;
        cof = 0;
      } else {
        cof = nc + 1;
      }
    }
  }
}

}  // namespace

extern "C" int vct_k1_huffman_decode(
    const uint8_t* flat, const int32_t* starts, const int32_t* lens,
    const int32_t* seg_blocks, int S, const int32_t* comp_sched, int B,
    int C, const int32_t* lo, const int32_t* hi, const int32_t* offset,
    int T, const int32_t* values, int V, int max_steps, int32_t* out,
    void* stream) {
  if (S <= 0) return (int)cudaGetLastError();
  const int threads = 128;
  const int blocks = (S + threads - 1) / threads;
  const size_t smem = (size_t)(3 * T * 16 + V) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(huffman_decode_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  huffman_decode_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      flat, starts, lens, seg_blocks, S, comp_sched, B, C, lo, hi, offset,
      T, values, V, max_steps, out);
  return (int)cudaGetLastError();
}
