// K2 — decode block datapath: dezigzag, dequant, 12-bit clamp, integer
// Chen IDCT, clip to [-128, 127], +128, uint8 pixels.
//
// Replaces: video_coding_tpu/ops/datapath.py _decode_kernel (the
//   pallas_call in decode_datapath_pallas). The TPU wrapper dezigzags and
//   pads outside its kernel and returns int32 pixels; here the dezigzag is
//   fused in and the pixels leave as uint8. Block i uses quant row
//   (i % P), so a period-P quant table (one restart segment's schedule)
//   stands in for the (N, 64) tiled table the TPU path materializes.
//
// What bounds it on an H100: memory. Each block reads 256 B of int32
//   coefficients and writes 64 B of pixels; the butterflies are ~700 int
//   operations a block, far below the card's integer rate. At the main
//   path's shape (N = 783,360) that is ~250 MB, ~75 us at 3.35 TB/s.
//
// What the design does about it: a CTA stages 32 blocks (8 KB) through
//   shared memory with fully coalesced loads, dequantizes and dezigzags on
//   the way in, runs the row pass and the column pass with 8 threads per
//   block (one row, then one column each), and writes the 2 KB of uint8
//   pixels back coalesced. The 181-multiply of the butterfly runs in
//   64-bit, which equals the reference's exact int32 split form.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlocksPerCta = 32;
constexpr int kThreads = kBlocksPerCta * 8;

// natural (raster) index of zigzag position p
__constant__ int kInverse[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

constexpr int W1 = 2841, W2 = 2676, W3 = 2408, W5 = 1609, W6 = 1108,
              W7 = 565;

__device__ __forceinline__ int mul181_shift8(int a) {
  return (int)((181ll * a + 128) >> 8);
}

// one 8-point pass; `row` selects the reference's row (shift 8) or column
// (shift 14, +8192 / +4 rounding) variant of the Chen IDCT
template <bool kRow>
__device__ __forceinline__ void idct8(int* v, int stride) {
  int x0, x1, x2, x3, x4, x5, x6, x7, x8;
  if (kRow) {
    x0 = v[0] * 2048 + 128;
    x1 = v[4 * stride] * 2048;
  } else {
    x0 = v[0] * 256 + 8192;
    x1 = v[4 * stride] * 256;
  }
  x2 = v[6 * stride];
  x3 = v[2 * stride];
  x4 = v[1 * stride];
  x5 = v[7 * stride];
  x6 = v[5 * stride];
  x7 = v[3 * stride];
  if (kRow) {
    x8 = W7 * (x4 + x5);
    x4 = x8 + (W1 - W7) * x4;
    x5 = x8 - (W1 + W7) * x5;
    x8 = W3 * (x6 + x7);
    x6 = x8 - (W3 - W5) * x6;
    x7 = x8 - (W3 + W5) * x7;
  } else {
    x8 = W7 * (x4 + x5) + 4;
    x4 = (x8 + (W1 - W7) * x4) >> 3;
    x5 = (x8 - (W1 + W7) * x5) >> 3;
    x8 = W3 * (x6 + x7) + 4;
    x6 = (x8 - (W3 - W5) * x6) >> 3;
    x7 = (x8 - (W3 + W5) * x7) >> 3;
  }
  x8 = x0 + x1;
  x0 = x0 - x1;
  if (kRow) {
    x1 = W6 * (x3 + x2);
    x2 = x1 - (W2 + W6) * x2;
    x3 = x1 + (W2 - W6) * x3;
  } else {
    x1 = W6 * (x3 + x2) + 4;
    x2 = (x1 - (W2 + W6) * x2) >> 3;
    x3 = (x1 + (W2 - W6) * x3) >> 3;
  }
  x1 = x4 + x6;
  x4 = x4 - x6;
  x6 = x5 + x7;
  x5 = x5 - x7;
  x7 = x8 + x3;
  x8 = x8 - x3;
  x3 = x0 + x2;
  x0 = x0 - x2;
  x2 = mul181_shift8(x4 + x5);
  x4 = mul181_shift8(x4 - x5);
  const int sh = kRow ? 8 : 14;
  v[0 * stride] = (x7 + x1) >> sh;
  v[1 * stride] = (x3 + x2) >> sh;
  v[2 * stride] = (x0 + x4) >> sh;
  v[3 * stride] = (x8 + x6) >> sh;
  v[4 * stride] = (x8 - x6) >> sh;
  v[5 * stride] = (x0 - x4) >> sh;
  v[6 * stride] = (x3 - x2) >> sh;
  v[7 * stride] = (x7 - x1) >> sh;
}

__global__ void __launch_bounds__(kThreads)
decode_datapath_kernel(const int32_t* __restrict__ coefs,
                       const int32_t* __restrict__ quant, int N, int P,
                       uint8_t* __restrict__ out) {
  __shared__ int tile[kBlocksPerCta * 64];
  __shared__ uint32_t pix[kBlocksPerCta * 16];
  const int base = blockIdx.x * kBlocksPerCta;
  const int tid = threadIdx.x;

  // coalesced load: element e of the CTA's 32x64 tile
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int e = k * kThreads + tid;
    const int b = e >> 6, pos = e & 63;
    const int blk = base + b;
    int deq = 0;
    if (blk < N) {
      const int z = coefs[(size_t)blk * 64 + pos];
      const int q = __ldg(quant + (size_t)(blk % P) * 64 + pos);
      // int32 product with two's-complement wrap, as the reference's
      deq = (int)((uint32_t)z * (uint32_t)q);
      deq = min(max(deq, -2048), 2047);
    }
    tile[b * 64 + kInverse[pos]] = deq;
  }
  __syncthreads();

  const int b = tid >> 3, r = tid & 7;
  idct8<true>(tile + b * 64 + r * 8, 1);  // row r
  __syncthreads();
  idct8<false>(tile + b * 64 + r, 8);  // column r
  __syncthreads();

  // clip + level shift, pack 4 pixels per word: thread t packs word t
  // and word t + 256 of the 512-word tile
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int w = k * kThreads + tid;
    uint32_t packed = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int v = min(max(tile[w * 4 + j], -128), 127) + 128;
      packed |= (uint32_t)v << (8 * j);
    }
    pix[w] = packed;
  }
  __syncthreads();
  uint32_t* out_w = reinterpret_cast<uint32_t*>(out);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int w = k * kThreads + tid;
    if (base + (w >> 4) < N) out_w[(size_t)base * 16 + w] = pix[w];
  }
}

}  // namespace

extern "C" int vct_k2_decode_datapath(const int32_t* coefs,
                                      const int32_t* quant, int N, int P,
                                      uint8_t* out, void* stream) {
  if (N <= 0) return (int)cudaGetLastError();
  const int blocks = (N + kBlocksPerCta - 1) / kBlocksPerCta;
  decode_datapath_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      coefs, quant, N, P, out);
  return (int)cudaGetLastError();
}
