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
//   coefficients and writes 64 B of pixels; at the main path's shape
//   (N = 783,360) that is ~250 MB, ~75 us at 3.35 TB/s. The ~1,100 integer
//   operations a block (two Chen passes, the dequant and both clamps) take
//   ~50 us at the card's int32 issue rate, so they must overlap the copies
//   rather than follow them.
//
// What the design does about it:
// - One thread owns one block: its 64 values live in registers, the
//   dezigzag is compile-time register indices (no table read at run time)
//   and both Chen passes are straight-line code. The +128 level shift is
//   folded into the column pass's DC term (2^21 before the >> 14; the
//   column sums stay below 2^30, tests/test_torch_datapath.py proves it).
// - Persistent CTAs (kCtasPerSm an SM) walk tiles of kBlocks blocks. A
//   tile's coefficients arrive by 16-byte cp.async copies, fully
//   coalesced, into shared memory XOR-swizzled by block, so that the
//   owner's 16-byte reads of its own block have no bank conflicts; with
//   several CTAs an SM one tile's copies overlap another's arithmetic.
// - The quant row is found with one modulo a block. A period of at most
//   kQuantRows rows (the main path's 6, path A's 24) is copied to shared
//   memory once a CTA, swizzled by row; a longer one is read with __ldg.
// - The pixels are packed four to a word and written back over the
//   owner's coefficients (a swizzle that is conflict-free for the owner
//   and for the store), then leave as coalesced 16-byte stores.
//
// Alignment: coefs and quant are read in 16-byte vectors, so both must
// start on a 16-byte boundary (the wrapper raises otherwise).

#include <cstdint>
#include <cuda_runtime.h>
#include <utility>

namespace {

constexpr int kBlocks = 128;    // blocks a tile = threads a CTA
constexpr int kThreads = kBlocks;
constexpr int kCtasPerSm = 3;   // persistent grid: SMs x this
constexpr int kQuantRows = 32;  // quant periods staged in shared memory

// natural (raster) index of zigzag position p
constexpr int kInverse[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

__host__ __device__ constexpr int natural_of(int p) { return kInverse[p]; }

constexpr int W1 = 2841, W2 = 2676, W3 = 2408, W5 = 1609, W6 = 1108,
              W7 = 565;

__device__ __forceinline__ int mul181_shift8(int a) {
  return (int)((181ll * a + 128) >> 8);
}

// one 8-point pass over v[I0], v[I0 + S], ..., v[I0 + 7S]: the
// reference's row (shift 8) or column (shift 14, +8192 and +4 rounding,
// here also +128 << 14, the level shift) variant of the Chen IDCT
template <int I0, int S, bool kRow>
__device__ __forceinline__ void idct8(int (&v)[64]) {
  int x0, x1, x2, x3, x4, x5, x6, x7, x8;
  if (kRow) {
    x0 = v[I0] * 2048 + 128;
    x1 = v[I0 + 4 * S] * 2048;
  } else {
    x0 = v[I0] * 256 + 8192 + (128 << 14);
    x1 = v[I0 + 4 * S] * 256;
  }
  x2 = v[I0 + 6 * S];
  x3 = v[I0 + 2 * S];
  x4 = v[I0 + 1 * S];
  x5 = v[I0 + 7 * S];
  x6 = v[I0 + 5 * S];
  x7 = v[I0 + 3 * S];
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
  constexpr int sh = kRow ? 8 : 14;
  v[I0 + 0 * S] = (x7 + x1) >> sh;
  v[I0 + 1 * S] = (x3 + x2) >> sh;
  v[I0 + 2 * S] = (x0 + x4) >> sh;
  v[I0 + 3 * S] = (x8 + x6) >> sh;
  v[I0 + 4 * S] = (x8 - x6) >> sh;
  v[I0 + 5 * S] = (x0 - x4) >> sh;
  v[I0 + 6 * S] = (x3 - x2) >> sh;
  v[I0 + 7 * S] = (x7 - x1) >> sh;
}

// rows (shift 8), then columns (shift 14, level shift folded in)
template <int... R>
__device__ __forceinline__ void idct2d(int (&v)[64],
                                       std::integer_sequence<int, R...>) {
  (idct8<R * 8, 1, true>(v), ...);
  (idct8<R, 8, false>(v), ...);
}

// int32 product with two's-complement wrap, as the reference's, then the
// 12-bit clamp
__device__ __forceinline__ int dequant(int z, int q) {
  const int d = (int)((uint32_t)z * (uint32_t)q);
  return min(max(d, -2048), 2047);
}

// zigzag positions 4K..4K+3 of a block, dequantized into natural order
template <int K>
__device__ __forceinline__ void dequant_chunk(int (&v)[64], int4 c, int4 q) {
  v[natural_of(4 * K)] = dequant(c.x, q.x);
  v[natural_of(4 * K + 1)] = dequant(c.y, q.y);
  v[natural_of(4 * K + 2)] = dequant(c.z, q.z);
  v[natural_of(4 * K + 3)] = dequant(c.w, q.w);
}

// the owner's block (chunk K at blk[K ^ sw]) times its quant row: staged
// in shared memory (chunk K at qrow[K ^ qsw]) or read from global memory
template <bool kStagedQ, int... K>
__device__ __forceinline__ void load_block(
    int (&v)[64], const int4* blk, int sw, const int4* qrow, int qsw,
    std::integer_sequence<int, K...>) {
  ((dequant_chunk<K>(v, blk[K ^ sw],
                     kStagedQ ? qrow[K ^ qsw] : __ldg(qrow + K))),
   ...);
}

// pixel values 4W..4W+3 (natural order), clipped to [0, 255], as a word
template <int W>
__device__ __forceinline__ uint32_t pack4(const int (&v)[64]) {
  const uint32_t a = (uint32_t)min(max(v[4 * W], 0), 255);
  const uint32_t b = (uint32_t)min(max(v[4 * W + 1], 0), 255);
  const uint32_t c = (uint32_t)min(max(v[4 * W + 2], 0), 255);
  const uint32_t d = (uint32_t)min(max(v[4 * W + 3], 0), 255);
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

template <int J>
__device__ __forceinline__ int4 pixel_chunk(const int (&v)[64]) {
  return make_int4((int)pack4<4 * J>(v), (int)pack4<4 * J + 1>(v),
                   (int)pack4<4 * J + 2>(v), (int)pack4<4 * J + 3>(v));
}

// slot of block i's pixel chunk j (rows 2j, 2j+1) inside its 16-chunk
// coefficient slots: distinct banks for 8 owners writing one j, and for
// the 2 blocks x 4 chunks that 8 neighbouring threads store
__device__ __forceinline__ int pixel_slot(int i, int j) {
  return (j ^ ((i >> 1) & 3)) + 4 * (i & 1);
}

__device__ __forceinline__ void cp_async16(void* smem_dst,
                                           const void* gmem_src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
decode_datapath_kernel(const int32_t* __restrict__ coefs,
                       const int32_t* __restrict__ quant, int N, int P,
                       uint8_t* __restrict__ out) {
  // coefficients: block i's chunk j (zigzag 4j..4j+3) at [i][j ^ (i & 7)],
  // its pixels afterwards at [i][pixel_slot(i, j)]; quant row r's chunk j
  // at [r][j ^ (r & 7)]
  __shared__ int4 s_c[kBlocks * 16];
  __shared__ int4 s_q[kQuantRows * 16];

  const int tid = threadIdx.x;
  const bool staged_q = P <= kQuantRows;
  if (staged_q)  // lands with the first tile's copies
    for (int c = tid; c < P * 16; c += kThreads)
      cp_async16(&s_q[(c >> 4) * 16 + ((c & 15) ^ ((c >> 4) & 7))],
                 quant + (size_t)c * 4);

  for (int base = blockIdx.x * kBlocks; base < N;
       base += gridDim.x * kBlocks) {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int c = k * kThreads + tid;
      const int i = c >> 4, j = c & 15;
      if (base + i < N)
        cp_async16(&s_c[i * 16 + (j ^ (i & 7))],
                   coefs + ((size_t)base * 64 + (size_t)c * 4));
    }
    cp_async_wait_all();
    __syncthreads();

    if (base + tid < N) {
      const int row = (int)((unsigned)(base + tid) % (unsigned)P);
      int v[64];
      if (staged_q)
        load_block<true>(v, &s_c[tid * 16], tid & 7, &s_q[row * 16],
                         row & 7, std::make_integer_sequence<int, 16>{});
      else
        load_block<false>(
            v, &s_c[tid * 16], tid & 7,
            reinterpret_cast<const int4*>(quant + (size_t)row * 64), 0,
            std::make_integer_sequence<int, 16>{});
      idct2d(v, std::make_integer_sequence<int, 8>{});
      int4* own = &s_c[tid * 16];
      own[pixel_slot(tid, 0)] = pixel_chunk<0>(v);
      own[pixel_slot(tid, 1)] = pixel_chunk<1>(v);
      own[pixel_slot(tid, 2)] = pixel_chunk<2>(v);
      own[pixel_slot(tid, 3)] = pixel_chunk<3>(v);
    }
    __syncthreads();

    // coalesced store of the tile's pixels: 4 chunks a block
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = k * kThreads + tid;
      const int i = c >> 2;
      if (base + i < N)
        reinterpret_cast<int4*>(out)[(size_t)base * 4 + c] =
            s_c[i * 16 + pixel_slot(i, c & 3)];
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int vct_k2_decode_datapath(const int32_t* coefs,
                                      const int32_t* quant, int N, int P,
                                      uint8_t* out, void* stream) {
  if (N <= 0) return (int)cudaGetLastError();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles = (N + kBlocks - 1) / kBlocks;
  const int ctas = tiles < sms * kCtasPerSm ? tiles : sms * kCtasPerSm;
  decode_datapath_kernel<<<ctas, kThreads, 0, (cudaStream_t)stream>>>(
      coefs, quant, N, P, out);
  return (int)cudaGetLastError();
}
