// K4 — the whole baseline entropy encoder, one thread per restart segment:
// DC differences against per-component predictors, size categories,
// Huffman lookups in packed (code << 5 | len) tables, AC run lengths with
// ZRL and EOB, 0xFF -> 0xFF00 stuffing and a flush with 1-bits.
//
// Replaces: video_coding_tpu/entropy/pallas_encode.py _fsm_kernel (the
//   pallas_call in encode_segments_fused). Same contract: (S, B*64) int32
//   quantized zigzag coefficients and an (S, B) valid mask in; per-segment
//   stuffed bytes in an m_out-byte slot, the byte length of each segment,
//   and an overflow flag (set when a segment needs more than m_out bytes;
//   bytes past m_out are dropped) out. Blocks with valid == 0 emit nothing
//   and leave the DC predictors alone.
//
// What bounds it on an H100: like K1, a serial state machine per lane —
//   up to 64 positions a block, each a table lookup and a bit-accumulator
//   update — with 130,560 lanes (~1000 per SM) at the main path's shape.
//   It is latency-bound; the 200 MB of int32 coefficients it reads are
//   ~60 us of bandwidth, less than the FSM's dependent chain.
//
// What the design does about it: the TPU kernel's one-hot table
//   reductions, fixed drain unrolls and word-packed output grids exist
//   because Mosaic has no per-lane gather or scatter. Here the tables sit
//   in shared memory, the 64-bit accumulator, predictors and byte cursor
//   in registers, each block walks only up to its last nonzero
//   coefficient, and bytes go straight to the segment's own output slot.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxComponents = 4;

struct BitSink {
  uint64_t acc;
  int nbits;
  int pos;
  int m_out;
  uint8_t* out;

  __device__ __forceinline__ void put(uint32_t val, int len) {
    if (len <= 0) return;
    const uint64_t v = (uint64_t)val & ((len >= 32) ? 0xFFFFFFFFull
                                                     : ((1ull << len) - 1));
    acc = (acc << len) | v;
    nbits += len;
    while (nbits >= 8) {
      const uint32_t byte = (uint32_t)(acc >> (nbits - 8)) & 0xFF;
      if (pos < m_out) out[pos] = (uint8_t)byte;
      ++pos;
      if (byte == 0xFF) {
        if (pos < m_out) out[pos] = 0;
        ++pos;
      }
      nbits -= 8;
    }
  }
};

// size category of v >= 0, saturating at 11 (the reference's 11-term sum)
__device__ __forceinline__ int size_category(int v) {
  const int bits = 32 - __clz(v);
  return bits < 11 ? bits : 11;
}

__device__ __forceinline__ uint32_t magnitude_bits(int v, int size) {
  return (uint32_t)(v >= 0 ? v : v - 1) & ((1u << size) - 1);
}

__global__ void huffman_encode_kernel(
    const int32_t* __restrict__ qc, const uint8_t* __restrict__ valid,
    int S, int B, const int32_t* __restrict__ comp_sched, int C,
    const int32_t* __restrict__ dctab_g, const int32_t* __restrict__ actab_g,
    int m_out, uint8_t* __restrict__ out, int32_t* __restrict__ lens,
    int32_t* __restrict__ overflow) {
  extern __shared__ int32_t smem[];
  int32_t* dctab = smem;            // C * 12
  int32_t* actab = smem + C * 12;   // C * 176
  for (int i = threadIdx.x; i < C * 12; i += blockDim.x) dctab[i] = dctab_g[i];
  for (int i = threadIdx.x; i < C * 176; i += blockDim.x)
    actab[i] = actab_g[i];
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= S) return;
  BitSink sink{0ull, 0, 0, m_out, out + (size_t)lane * m_out};
  int dcpred[kMaxComponents] = {0, 0, 0, 0};

  for (int b = 0; b < B; ++b) {
    if (!valid[(size_t)lane * B + b]) continue;
    // schedule entries past the tables clamp to the last component (the
    // sessions never produce them)
    const int comp = min(max(__ldg(comp_sched + b), 0), C - 1);
    const int32_t* row = qc + ((size_t)lane * B + b) * 64;
    const int32_t* dcrow = dctab + comp * 12;
    const int32_t* acrow = actab + comp * 176;

    // DC: difference against the component's predictor
    const int coef0 = row[0];
    const int diff = coef0 - dcpred[comp];
    dcpred[comp] = coef0;
    const int dsize = size_category(diff < 0 ? -diff : diff);
    const int dpk = dcrow[dsize];
    sink.put(((uint32_t)dpk >> 5 << dsize) | magnitude_bits(diff, dsize),
             (dpk & 31) + dsize);

    // AC positions 1..last nonzero
    int last_nz = 0;
    for (int j = 63; j >= 1; --j) {
      if (row[j] != 0) {
        last_nz = j;
        break;
      }
    }
    int run = 0;
    const int zpk = acrow[15 * 11];
    for (int j = 1; j <= last_nz; ++j) {
      const int coef = row[j];
      if (coef == 0) {
        if (++run == 16) {
          sink.put((uint32_t)zpk >> 5, zpk & 31);
          run = 0;
        }
        continue;
      }
      const int asize = size_category(coef < 0 ? -coef : coef);
      const int idx = run * 11 + asize;
      const int apk = idx < 176 ? acrow[idx] : 0;
      sink.put(((uint32_t)apk >> 5 << asize) | magnitude_bits(coef, asize),
               (apk & 31) + asize);
      run = 0;
    }
    if (last_nz < 63) {
      const int epk = acrow[0];
      sink.put((uint32_t)epk >> 5, epk & 31);
    }
  }
  // flush to a byte boundary with 1-bits
  const int pad = (-sink.nbits) & 7;
  sink.put((1u << pad) - 1, pad);
  lens[lane] = sink.pos;
  if (sink.pos > m_out) atomicOr(overflow, 1);
}

}  // namespace

extern "C" int vct_k4_huffman_encode(
    const int32_t* qc, const uint8_t* valid, int S, int B,
    const int32_t* comp_sched, int C, const int32_t* dctab,
    const int32_t* actab, int m_out, uint8_t* out, int32_t* lens,
    int32_t* overflow, void* stream) {
  if (S <= 0) return (int)cudaGetLastError();
  const int threads = 128;
  const int blocks = (S + threads - 1) / threads;
  const size_t smem = (size_t)C * (12 + 176) * sizeof(int32_t);
  huffman_encode_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      qc, valid, S, B, comp_sched, C, dctab, actab, m_out, out, lens,
      overflow);
  return (int)cudaGetLastError();
}
