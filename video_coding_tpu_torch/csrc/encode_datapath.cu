// K3 — encode block datapath: -128 level shift, integer Chen fDCT (x4
// scaled), zigzag, round-half-away-from-zero quantization.
//
// Replaces: video_coding_tpu/ops/datapath.py _encode_kernel (the
//   pallas_call in encode_datapath_pallas). The TPU kernel computes only
//   the fDCT; its wrapper zigzags and quantizes in XLA with an f32
//   reciprocal plus two integer corrections. Here all of it is one kernel
//   that reads the uint8 block-gathered pixels directly and quantizes
//   with an exact integer division. Block i uses quant row (i % P).
//
// What bounds it on an H100: memory. Each block reads 64 B of pixels and
//   writes 256 B of int32 coefficients; ~600 integer operations and 64
//   divisions a block stay far below the card's rate. At the main path's
//   shape (N = 783,360) that is ~250 MB, ~75 us at 3.35 TB/s.
//
// What the design does about it: a CTA stages 32 blocks (2 KB of pixels)
//   through shared memory with coalesced 32-bit loads, runs the column
//   pass then the row pass with 8 threads per block, and writes the
//   quantized zigzag coefficients back fully coalesced.

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

// one 8-point forward Chen pass (the reference's dct_col / dct_row)
__device__ __forceinline__ void fdct8(int* v, int stride) {
  int a0 = v[0] + v[7 * stride];
  int c3 = v[0] - v[7 * stride];
  int a1 = v[1 * stride] + v[6 * stride];
  int c2 = v[1 * stride] - v[6 * stride];
  int a2 = v[2 * stride] + v[5 * stride];
  int c1 = v[2 * stride] - v[5 * stride];
  int a3 = v[3 * stride] + v[4 * stride];
  int c0 = v[3 * stride] - v[4 * stride];
  int b0 = a0 + a3;
  int b1 = a1 + a2;
  const int b2 = a1 - a2;
  const int b3 = a0 - a3;
  const int o0 = (362 * (b0 + b1)) >> 9;
  const int o4 = (362 * (b0 - b1)) >> 9;
  const int o2 = (196 * b2 + 473 * b3) >> 9;
  const int o6 = (196 * b3 - 473 * b2) >> 9;
  b0 = (362 * (c2 - c1)) >> 9;
  b1 = (362 * (c2 + c1)) >> 9;
  a0 = c0 + b0;
  a1 = c0 - b0;
  a2 = c3 - b1;
  a3 = c3 + b1;
  v[0] = o0;
  v[1 * stride] = (100 * a0 + 502 * a3) >> 9;
  v[2 * stride] = o2;
  v[3 * stride] = (426 * a2 - 284 * a1) >> 9;
  v[4 * stride] = o4;
  v[5 * stride] = (426 * a1 + 284 * a2) >> 9;
  v[6 * stride] = o6;
  v[7 * stride] = (100 * a3 - 502 * a0) >> 9;
}

__global__ void __launch_bounds__(kThreads)
encode_datapath_kernel(const uint8_t* __restrict__ pixels,
                       const int32_t* __restrict__ quant, int N, int P,
                       int32_t* __restrict__ out) {
  __shared__ int tile[kBlocksPerCta * 64];
  const int base = blockIdx.x * kBlocksPerCta;
  const int tid = threadIdx.x;
  const uint32_t* px_w = reinterpret_cast<const uint32_t*>(pixels);

  // coalesced load: 512 words of 4 pixels, 2 per thread
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int w = k * kThreads + tid;
    const uint32_t word =
        (base + (w >> 4) < N) ? px_w[(size_t)base * 16 + w] : 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      tile[w * 4 + j] = (int)((word >> (8 * j)) & 0xFF) - 128;
  }
  __syncthreads();

  const int b = tid >> 3, r = tid & 7;
  fdct8(tile + b * 64 + r, 8);  // column r (along the rows)
  __syncthreads();
  fdct8(tile + b * 64 + r * 8, 1);  // row r
  __syncthreads();

  // quantize in zigzag order, coalesced store
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int e = k * kThreads + tid;
    const int bl = e >> 6, pos = e & 63;
    const int blk = base + bl;
    if (blk < N) {
      const int f = tile[bl * 64 + kInverse[pos]];
      const int q = __ldg(quant + (size_t)(blk % P) * 64 + pos);
      const int n = (f < 0 ? -f : f) + 2 * q;
      const int t = n / (4 * q);
      out[(size_t)blk * 64 + pos] = f < 0 ? -t : t;
    }
  }
}

}  // namespace

extern "C" int vct_k3_encode_datapath(const uint8_t* pixels,
                                      const int32_t* quant, int N, int P,
                                      int32_t* out, void* stream) {
  if (N <= 0) return (int)cudaGetLastError();
  const int blocks = (N + kBlocksPerCta - 1) / kBlocksPerCta;
  encode_datapath_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      pixels, quant, N, P, out);
  return (int)cudaGetLastError();
}
