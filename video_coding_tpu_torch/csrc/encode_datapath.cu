// K3 — encode block datapath: -128 level shift, integer Chen fDCT (x4
// scaled), zigzag, round-half-away-from-zero quantization.
//
// Replaces: video_coding_tpu/ops/datapath.py _encode_kernel (the
//   pallas_call in encode_datapath_pallas). The TPU kernel computes only
//   the fDCT; its wrapper zigzags and quantizes in XLA with an f32
//   reciprocal plus two integer corrections. Here all of it is one kernel
//   that reads the uint8 block-gathered pixels directly. Block i uses
//   quant row (i % P).
//
// What bounds it on an H100: memory. Each block reads 64 B of pixels and
//   writes 256 B of int32 coefficients; at the main path's shape
//   (N = 783,360) that is ~250 MB, ~75 us at 3.35 TB/s. The quant rows are
//   read again for every period of P blocks (16 times a dispatch there),
//   mostly from L2. ~1,400 integer operations a block stay below that.
//
// What the design does about it:
// - One thread owns one block: the 64 values live in registers, both Chen
//   passes and the zigzag are straight-line code with compile-time
//   register indices (no shared-memory transposes, no constant-memory
//   table reads), and the -128 level shift is folded into the first pass
//   (it moves only the DC term of each column).
// - A CTA walks tiles of kBlocks blocks (persistent, grid-stride). The
//   tile's pixels (16-byte cp.async copies) and quant rows (one modulo a
//   thread a tile, then an add-and-subtract per row) are staged in shared
//   memory, fully coalesced; the quantized coefficients are written back
//   into the quant slots and leave as coalesced 16-byte stores. Both
//   buffers are XOR-swizzled by block so that neither the coalesced side
//   nor the block-owner side has bank conflicts.
// - The quotient trunc((|f| + 2q) / 4q) is an exact reciprocal multiply,
//   umulhi(n, m) with m = floor((2^32 - 1) / 4q) + 1 from a per-CTA table
//   (kRecipQuant entries): exact for every dividend n < 2^17 and
//   q <= kRecipQuant (tests/test_torch_datapath.py proves it over all of
//   them). |f| < 2^13 for 8-bit input, so n < 2^17 for those q. A chunk
//   with any q outside 1..kRecipQuant takes the integer division.
//
// Alignment: pixels and quant are read in 16-byte vectors, so both must
// start on a 16-byte boundary (the wrapper raises otherwise).

#include <cstdint>
#include <cuda_runtime.h>
#include <utility>

namespace {

constexpr int kBlocks = 128;          // blocks a tile = threads a CTA
constexpr int kThreads = kBlocks;
constexpr int kCtasPerSm = 4;         // persistent grid: SMs x this
constexpr int kRecipQuant = 1024;     // quant values with a table entry

// natural (raster) index of zigzag position p
constexpr int kInverse[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

__host__ __device__ constexpr int natural_of(int p) { return kInverse[p]; }

// one 8-point forward Chen pass (the reference's dct_col / dct_row) over
// v[I0], v[I0 + S], ..., v[I0 + 7S]; kBias is added to b0 + b1 (the DC
// sum), which is how the first pass applies the -128 level shift
template <int I0, int S, int kBias>
__device__ __forceinline__ void fdct8(int (&v)[64]) {
  int a0 = v[I0] + v[I0 + 7 * S];
  int c3 = v[I0] - v[I0 + 7 * S];
  int a1 = v[I0 + 1 * S] + v[I0 + 6 * S];
  int c2 = v[I0 + 1 * S] - v[I0 + 6 * S];
  int a2 = v[I0 + 2 * S] + v[I0 + 5 * S];
  int c1 = v[I0 + 2 * S] - v[I0 + 5 * S];
  int a3 = v[I0 + 3 * S] + v[I0 + 4 * S];
  int c0 = v[I0 + 3 * S] - v[I0 + 4 * S];
  int b0 = a0 + a3;
  int b1 = a1 + a2;
  const int b2 = a1 - a2;
  const int b3 = a0 - a3;
  const int o0 = (362 * (b0 + b1 + kBias)) >> 9;
  const int o4 = (362 * (b0 - b1)) >> 9;
  const int o2 = (196 * b2 + 473 * b3) >> 9;
  const int o6 = (196 * b3 - 473 * b2) >> 9;
  b0 = (362 * (c2 - c1)) >> 9;
  b1 = (362 * (c2 + c1)) >> 9;
  a0 = c0 + b0;
  a1 = c0 - b0;
  a2 = c3 - b1;
  a3 = c3 + b1;
  v[I0] = o0;
  v[I0 + 1 * S] = (100 * a0 + 502 * a3) >> 9;
  v[I0 + 2 * S] = o2;
  v[I0 + 3 * S] = (426 * a2 - 284 * a1) >> 9;
  v[I0 + 4 * S] = o4;
  v[I0 + 5 * S] = (426 * a1 + 284 * a2) >> 9;
  v[I0 + 6 * S] = o6;
  v[I0 + 7 * S] = (100 * a3 - 502 * a0) >> 9;
}

// columns (the first pass, with the level shift: 8 pixels of -128 sum to
// b0 + b1 - 1024; every other term is a difference), then rows
template <int... C>
__device__ __forceinline__ void fdct2d(int (&v)[64],
                                       std::integer_sequence<int, C...>) {
  (fdct8<C, 8, -1024>(v), ...);
  (fdct8<C * 8, 1, 0>(v), ...);
}

__device__ __forceinline__ int quantize(int f, int q, uint32_t m) {
  const uint32_t n = (uint32_t)(f < 0 ? -f : f) + 2u * (uint32_t)q;
  const int t = (int)__umulhi(n, m);
  return f < 0 ? -t : t;
}

// the exact integer form for quant values without a table entry
__device__ __forceinline__ int quantize_div(int f, int q) {
  const int n = (f < 0 ? -f : f) + (int)(2u * (uint32_t)q);
  const int t = n / (int)(4u * (uint32_t)q);
  return f < 0 ? -t : t;
}

// zigzag positions 4k..4k+3 of the block in v, quantized by qv
template <int K>
__device__ __forceinline__ int4 quantize_chunk(const int (&v)[64], int4 qv,
                                               const uint32_t* recip) {
  constexpr int n0 = natural_of(4 * K), n1 = natural_of(4 * K + 1),
                n2 = natural_of(4 * K + 2), n3 = natural_of(4 * K + 3);
  const uint32_t span = ((uint32_t)qv.x - 1u) | ((uint32_t)qv.y - 1u) |
                        ((uint32_t)qv.z - 1u) | ((uint32_t)qv.w - 1u);
  if (span < (uint32_t)kRecipQuant)
    return make_int4(quantize(v[n0], qv.x, recip[qv.x]),
                     quantize(v[n1], qv.y, recip[qv.y]),
                     quantize(v[n2], qv.z, recip[qv.z]),
                     quantize(v[n3], qv.w, recip[qv.w]));
  return make_int4(quantize_div(v[n0], qv.x), quantize_div(v[n1], qv.y),
                   quantize_div(v[n2], qv.z), quantize_div(v[n3], qv.w));
}

template <int... K>
__device__ __forceinline__ void quantize_block(
    const int (&v)[64], int4* slot, int sw, const uint32_t* recip,
    std::integer_sequence<int, K...>) {
  ((slot[K ^ sw] = quantize_chunk<K>(v, slot[K ^ sw], recip)), ...);
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
encode_datapath_kernel(const uint8_t* __restrict__ pixels,
                       const int32_t* __restrict__ quant, int N, int P,
                       int32_t* __restrict__ out) {
  // pixels: block i's 16-byte chunk j at [i][j ^ ((i >> 1) & 3)];
  // quant / coefficients: block i's chunk j (zigzag 4j..4j+3) at
  // [i][j ^ (i & 7)]
  __shared__ uint4 s_px[kBlocks * 4];
  __shared__ int4 s_q[kBlocks * 16];
  __shared__ uint32_t s_recip[kRecipQuant + 1];

  const int tid = threadIdx.x;
  for (int q = tid; q <= kRecipQuant; q += kThreads)
    s_recip[q] = q ? 0xFFFFFFFFu / (4u * (uint32_t)q) + 1u : 0u;
  const int row_step = 8 % P;  // rows advance 8 blocks per copy below

  for (int base = blockIdx.x * kBlocks; base < N;
       base += gridDim.x * kBlocks) {
    // stage the tile: 4 pixel chunks and 16 quant chunks a thread
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = k * kThreads + tid;
      const int i = c >> 2, j = c & 3;
      if (base + i < N)
        cp_async16(&s_px[i * 4 + (j ^ ((i >> 1) & 3))],
                   pixels + ((size_t)base * 64 + (size_t)c * 16));
    }
    int row = (int)((unsigned)(base + (tid >> 4)) % (unsigned)P);
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int i = k * (kThreads / 16) + (tid >> 4), j = tid & 15;
      if (base + i < N)
        cp_async16(&s_q[i * 16 + (j ^ (i & 7))],
                   quant + (size_t)row * 64 + j * 4);
      row += row_step;
      if (row >= P) row -= P;
    }
    cp_async_wait_all();
    __syncthreads();

    // the thread's own block: unpack, two passes, quantize in place
    int v[64];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint4 w = s_px[tid * 4 + (j ^ ((tid >> 1) & 3))];
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int k = 0; k < 16; ++k)
        v[j * 16 + k] = (int)__byte_perm(words[k >> 2], 0, 0x4440 | (k & 3));
    }
    fdct2d(v, std::make_integer_sequence<int, 8>{});
    quantize_block(v, &s_q[tid * 16], tid & 7, s_recip,
                   std::make_integer_sequence<int, 16>{});
    __syncthreads();

    // coalesced store of the tile's coefficients
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int c = k * kThreads + tid;
      const int i = c >> 4, j = c & 15;
      if (base + i < N)
        reinterpret_cast<int4*>(out)[(size_t)base * 16 + c] =
            s_q[i * 16 + (j ^ (i & 7))];
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int vct_k3_encode_datapath(const uint8_t* pixels,
                                      const int32_t* quant, int N, int P,
                                      int32_t* out, void* stream) {
  if (N <= 0) return (int)cudaGetLastError();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles = (N + kBlocks - 1) / kBlocks;
  const int ctas = tiles < sms * kCtasPerSm ? tiles : sms * kCtasPerSm;
  encode_datapath_kernel<<<ctas, kThreads, 0, (cudaStream_t)stream>>>(
      pixels, quant, N, P, out);
  return (int)cudaGetLastError();
}
