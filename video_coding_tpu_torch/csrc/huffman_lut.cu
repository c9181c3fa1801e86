// The two-level lookup table of the Huffman decode kernels K1, K5, K6 and
// K7, built on the card from the range tables once per call (layout in
// huffman_decode_lut.cuh; plain version: huffman_decode.decode_lut_plain).
//
// Pass 1, one thread a 16-bit window (T · 65,536 threads): match() of the
//   window; a warp vote and a shared pair of flags tell whether the 64
//   windows of a prefix agree. Level-1 entry: the common result, or a mark.
// Pass 2, one CTA: the marked prefixes, in order, take the level-2 blocks
//   until they run out (then kLutFallback), and each block gets the
//   match() of its 64 windows.
//
// Replaces nothing of the TPU kernels by itself: it stands in for the
// range compare of their symbol loops (`lookup` in
// video_coding_tpu/entropy/pallas_decode.py _symbol_loop_t, _kernel and
// _kernel_bs), which K1, K5, K6 and K7 now run only past the level-2
// blocks.

#include "huffman_decode_lut.cuh"

namespace {

using namespace vct;

constexpr unsigned kMark = 0xFFFF;
constexpr int kPass2Threads = 1024;

__global__ void __launch_bounds__(256) lut_level1_kernel(
    const int32_t* __restrict__ lo, const int32_t* __restrict__ hi,
    const int32_t* __restrict__ off, int T,
    const int32_t* __restrict__ values, int V, int16_t* __restrict__ lut) {
  static_assert(kLutSpan == 64, "a prefix is two warps");
  __shared__ int s_res[8];
  __shared__ int s_same[8];
  __shared__ int32_t s_row[3 * 16];  // lo, hi, off of this CTA's table row
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // t · 2^16 + window
  const int t = i >> 16;
  if (threadIdx.x < 48) {
    const int32_t* src = threadIdx.x < 16 ? lo : threadIdx.x < 32 ? hi : off;
    s_row[threadIdx.x] = src[t * 16 + (threadIdx.x & 15)];
  }
  __syncthreads();
  const Tables tb{s_row, s_row + 16, s_row + 32, values, V};
  int code_len, data;
  match(tb, 0, i & 0xFFFF, code_len, data);
  const int res = (code_len << 8) | data;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int first = __shfl_sync(~0u, res, 0);
  const bool same = __all_sync(~0u, res == first);
  if (lane == 0) {
    s_res[warp] = first;
    s_same[warp] = same;
  }
  __syncthreads();
  if (lane == 0 && (warp & 1) == 0) {
    const bool uniform = s_same[warp] && s_same[warp + 1] &&
                         s_res[warp] == s_res[warp + 1] &&
                         (s_res[warp] >> 8) <= 16;
    lut[i >> (16 - kLutBits)] = (int16_t)(uniform ? s_res[warp] : (int)kMark);
  }
}

__global__ void __launch_bounds__(kPass2Threads) lut_level2_kernel(
    const int32_t* __restrict__ lo, const int32_t* __restrict__ hi,
    const int32_t* __restrict__ off, int T,
    const int32_t* __restrict__ values, int V, int16_t* __restrict__ lut) {
  __shared__ int s_count[kPass2Threads / 32];
  __shared__ int s_src[kLutPool];
  __shared__ int s_total;
  const int n = T * kLutSize;
  const int per = (n + kPass2Threads - 1) / kPass2Threads;
  const int i0 = min((int)threadIdx.x * per, n), i1 = min(i0 + per, n);
  int c = 0;
  for (int i = i0; i < i1; ++i) c += (uint16_t)lut[i] == kMark;
  // exclusive prefix of the marks over the threads, in order
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = c;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(~0u, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) s_count[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = s_count[lane], wi = w;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(~0u, wi, o);
      if (lane >= o) wi += v;
    }
    s_count[lane] = wi - w;  // warps before this one
    if (lane == 31) s_total = wi;
  }
  __syncthreads();
  int slot = s_count[warp] + incl - c;
  for (int i = i0; i < i1; ++i) {
    if ((uint16_t)lut[i] != kMark) continue;
    if (slot < kLutPool) {
      s_src[slot] = i;
      lut[i] = (int16_t)(kLutPooled | slot);
    } else {
      lut[i] = (int16_t)kLutFallback;
    }
    ++slot;
  }
  __syncthreads();
  const Tables tb{lo, hi, off, values, V};
  int16_t* pool = lut + n;
  for (int j = threadIdx.x; j < kLutPool * kLutSpan; j += kPass2Threads) {
    const int s = j / kLutSpan;
    int res = 0;
    if (s < min(s_total, kLutPool)) {
      const int src = s_src[s];
      int code_len, data;
      match(tb, src / kLutSize,
            (src % kLutSize) * kLutSpan + j % kLutSpan, code_len, data);
      res = (code_len << 8) | data;
    }
    pool[j] = (int16_t)res;
  }
}

}  // namespace

extern "C" int vct_huffman_lut(const int32_t* lo, const int32_t* hi,
                               const int32_t* offset, int T,
                               const int32_t* values, int V, int16_t* lut,
                               void* stream) {
  if (T <= 0) return (int)cudaGetLastError();
  lut_level1_kernel<<<T * 65536 / 256, 256, 0, (cudaStream_t)stream>>>(
      lo, hi, offset, T, values, V, lut);
  lut_level2_kernel<<<1, kPass2Threads, 0, (cudaStream_t)stream>>>(
      lo, hi, offset, T, values, V, lut);
  return (int)cudaGetLastError();
}
