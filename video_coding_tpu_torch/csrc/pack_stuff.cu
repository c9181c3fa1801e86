// K8 — the split entropy encoder's bit packer, one warp per restart
// segment: symbol slots (hi, lo, length) in, stuffed wire bytes out.
//
// Replaces: video_coding_tpu/entropy/pallas_encode.py _kernel (the
//   pallas_call in pack_stuff_pallas). Same contract: per lane, for
//   k = 0..K-1 the low c_len[k] bits of the 64-bit value
//   (c_hi[k] << 32) | c_lo[k] are appended MSB-first (bits at or above the
//   length may be garbage and are masked; a zero length is a no-op), each
//   completed byte is written at the lane's cursor, and after a 0xFF byte
//   the cursor advances one more over a stuffed 0x00. A byte whose cursor
//   is at or past m_out is dropped while the cursor goes on counting; bits
//   that end a lane short of a byte are dropped. out_lens is the final
//   cursor; overflow is set when a lane's raw_bytes_len exceeds m_raw or
//   its cursor ends past m_out. Lengths are clamped to 0..59. The kernel
//   writes every byte of out — data, stuffed zeros and the zero tail up to
//   m_out — so out needs no zeroing pass.
//
// What bounds it on an H100: bytes. The three (S, K) int32 slot arrays are
//   611 MB at S = 16,320 lanes of K = 3,121 slots (a 16-frame 1080p
//   dispatch with 48 blocks a segment) against ~21 MB of output; about 9%
//   of the slots hold bits, and they cluster at the low zigzag positions of
//   each block's 65.
//
// What the design does about it: a lane is one warp, which walks its slots
//   in chunks of kChunkSlots, slot c0 + 32·j + t to thread t — so every
//   load of a lane's row is a coalesced 128-byte request. c_len is read in
//   full, one chunk ahead; c_lo only for slots with bits and c_hi only for
//   slots of more than 32 bits, so the sectors of the value arrays that
//   hold only empty slots are never fetched. For each chunk:
//   1. two warp scans of the lengths (four rows of 32 slots, two packed
//      16-bit sums a register) give every slot its bit offset after the
//      bits already in the warp's shared-memory buffer of kBufWords words;
//   2. each slot's <= 59 bits are OR-ed into that buffer (at most three
//      words a slot; atomics, since neighbouring slots share words).
//   3. Once the buffer holds more than kFlushBits bits (so that the next
//      chunk might not fit), and at the lane's end, its completed bytes
//      are stuffed in parallel, a word a thread: a ballot-and-popc prefix
//      of the 0xFF counts gives byte i the cursor base + i + (0xFF bytes
//      before it). The words are cleared as they are read, and the partial
//      byte moves to the head of word 0. A lane of ~200 bytes thus takes
//      one or two stuffing passes, not one a chunk.
//   Shared memory is fixed (kBufWords a warp) whatever the lane's length.
//   The TPU kernel's sublane-major (K, CHUNK) layout, one-hot byte writes
//   into a word-packed grid and fixed 4-pass drain are Mosaic's and are not
//   carried.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;           // lanes a CTA, a warp each
constexpr int kChunkSlots = 128;    // slots a warp scans at a time
constexpr int kRows = kChunkSlots / 32;
constexpr int kMaxSlotBits = 59;
constexpr int kBufWords = 512;      // bit buffer a warp
// the buffer is stuffed out once it holds more bits than this, so a chunk
// of full slots always fits
constexpr int kFlushBits = 32 * kBufWords - kChunkSlots * kMaxSlotBits;
static_assert(kRows == 4, "the scan packs two rows of slots a register");
static_assert(kFlushBits >= 7, "a chunk and a partial byte must fit");
static_assert(32 * kMaxSlotBits < (1 << 16), "a row's sum fits 16 bits");

// Inclusive warp scan of two 16-bit sums packed in one word (no carry
// crosses the halves: a row of 32 slots sums to at most 1,888).
__device__ __forceinline__ uint32_t scan2(uint32_t x, int t) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(~0u, x, o);
    if (t >= o) x += y;
  }
  return x;
}

// OR the low len bits of (hi, lo) (1 <= len <= 59) into buf at bit o,
// MSB-first.
__device__ __forceinline__ void put_bits(uint32_t* buf, int o, int len,
                                         uint32_t hi, uint32_t lo) {
  const uint64_t v =
      (((uint64_t)hi << 32) | lo) & ((1ull << len) - 1);
  const int w = o >> 5;
  const int s = 96 - (o & 31) - len;  // v's shift in words w..w+2: 6..95
  uint64_t top;
  uint32_t w2 = 0;
  if (s >= 32) {
    top = v << (s - 32);
  } else {
    top = v >> (32 - s);
    w2 = (uint32_t)(v << s);
  }
  if ((uint32_t)(top >> 32)) atomicOr(buf + w, (uint32_t)(top >> 32));
  if ((uint32_t)top) atomicOr(buf + w + 1, (uint32_t)top);
  if (w2) atomicOr(buf + w + 2, w2);
}

// Write the first nbits >> 3 bytes of buf at the cursor pos with 0xFF
// stuffing (dropping bytes at or past m_out), clear the words read, move
// the partial byte to the head of word 0, and return the new cursor.
// Thread t takes word w0 + t of each round.
__device__ __forceinline__ int stuff(uint32_t* buf, int nbits, int t,
                                     int pos, uint8_t* dst, int m_out) {
  __syncwarp();  // the slots' bits are in
  const uint32_t part =
      (nbits & 7) ? (buf[nbits >> 5] >> (24 - (nbits & 24))) & 0xFF : 0u;
  __syncwarp();
  const int nbytes = nbits >> 3;
  const int nwords = (nbits + 31) >> 5;
  const unsigned lt = (1u << t) - 1;
  for (int w0 = 0; w0 < nwords; w0 += 32) {
    const int w = w0 + t;
    uint32_t x = 0;
    if (w < nwords) {
      x = buf[w];
      buf[w] = 0;
    }
    const int nb = min(max(nbytes - 4 * w, 0), 4);  // complete bytes here
    unsigned ff = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (b < nb && ((x >> (24 - 8 * b)) & 0xFF) == 0xFF) ff |= 1u << b;
    const int nff = __popc(ff);
    const unsigned m0 = __ballot_sync(~0u, nff & 1);
    const unsigned m1 = __ballot_sync(~0u, nff & 2);
    const unsigned m2 = __ballot_sync(~0u, nff & 4);
    int p = pos + 4 * t + __popc(m0 & lt) + 2 * __popc(m1 & lt) +
            4 * __popc(m2 & lt);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (b < nb) {
        if (p < m_out) dst[p] = (uint8_t)(x >> (24 - 8 * b));
        if ((ff >> b) & 1) {
          if (p + 1 < m_out) dst[p + 1] = 0;
          ++p;
        }
        ++p;
      }
    }
    pos += min(nbytes - 4 * w0, 128) + __popc(m0) + 2 * __popc(m1) +
           4 * __popc(m2);
  }
  __syncwarp();
  if (t == 0) buf[0] = part << 24;
  __syncwarp();
  return pos;
}

// Zero bytes [z, m_out) of the row: single bytes up to a 16-byte boundary,
// 16-byte stores, single bytes after.
__device__ __forceinline__ void zero_tail(uint8_t* dst, int z, int m_out,
                                          int t) {
  uint8_t* p = dst + z;
  uint8_t* const end = dst + m_out;
  uint8_t* a16 = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 15) & ~(uintptr_t)15);
  if (a16 > end) a16 = end;
  if (t < a16 - p) p[t] = 0;
  const long long nvec = (end - a16) / 16;
  for (long long i = t; i < nvec; i += 32)
    reinterpret_cast<uint4*>(a16)[i] = make_uint4(0, 0, 0, 0);
  uint8_t* const rest = a16 + 16 * nvec;
  if (t < end - rest) rest[t] = 0;
}

__global__ void __launch_bounds__(kWarps * 32) pack_stuff_kernel(
    const int32_t* __restrict__ c_hi, const int32_t* __restrict__ c_lo,
    const int32_t* __restrict__ c_len,
    const int32_t* __restrict__ raw_bytes_len, int S, int K, int m_raw,
    int m_out, uint8_t* __restrict__ out, int32_t* __restrict__ out_lens,
    int32_t* __restrict__ overflow) {
  __shared__ uint32_t s_buf[kWarps][kBufWords];
  const int t = threadIdx.x & 31;
  const int lane = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (lane >= S) return;  // whole warps leave together
  uint32_t* buf = s_buf[threadIdx.x >> 5];
  for (int i = t; i < kBufWords; i += 32) buf[i] = 0;
  __syncwarp();

  const size_t row = (size_t)lane * K;
  const int32_t* len_row = c_len + row;
  const uint32_t* hi_row = reinterpret_cast<const uint32_t*>(c_hi + row);
  const uint32_t* lo_row = reinterpret_cast<const uint32_t*>(c_lo + row);
  uint8_t* dst = out + (size_t)lane * m_out;
  int pos = 0;    // the cursor, stuffed bytes included
  int nbits = 0;  // bits in buf, from the head of buf[0]

  int ahead[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j)
    ahead[j] = 32 * j + t < K ? __ldg(len_row + 32 * j + t) : 0;
  for (int c0 = 0; c0 < K; c0 += kChunkSlots) {
    int len[kRows];
    uint32_t hi[kRows], lo[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int k = c0 + 32 * j + t;
      len[j] = min(max(ahead[j], 0), kMaxSlotBits);
      lo[j] = len[j] > 0 ? __ldg(lo_row + k) : 0u;
      hi[j] = len[j] > 32 ? __ldg(hi_row + k) : 0u;
    }
    const int c1 = c0 + kChunkSlots;
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      ahead[j] = c1 + 32 * j + t < K ? __ldg(len_row + c1 + 32 * j + t) : 0;

    // 1. bit offsets
    const uint32_t x01 = scan2((uint32_t)len[0] | ((uint32_t)len[1] << 16), t);
    const uint32_t x23 = scan2((uint32_t)len[2] | ((uint32_t)len[3] << 16), t);
    const uint32_t tot01 = __shfl_sync(~0u, x01, 31);
    const uint32_t tot23 = __shfl_sync(~0u, x23, 31);
    const int r0 = (int)(tot01 & 0xFFFF), r1 = (int)(tot01 >> 16);
    const int r2 = (int)(tot23 & 0xFFFF), r3 = (int)(tot23 >> 16);
    if (r0 + r1 + r2 + r3 == 0) continue;  // no bits in this chunk
    const int off[kRows] = {
        nbits + (int)(x01 & 0xFFFF) - len[0],
        nbits + r0 + (int)(x01 >> 16) - len[1],
        nbits + r0 + r1 + (int)(x23 & 0xFFFF) - len[2],
        nbits + r0 + r1 + r2 + (int)(x23 >> 16) - len[3]};
    nbits += r0 + r1 + r2 + r3;

    // 2. the slots' bits into the buffer
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      if (len[j] > 0) put_bits(buf, off[j], len[j], hi[j], lo[j]);

    // 3. stuff the completed bytes once another chunk might not fit
    if (nbits > kFlushBits) {
      pos = stuff(buf, nbits, t, pos, dst, m_out);
      nbits &= 7;
    }
  }
  pos = stuff(buf, nbits, t, pos, dst, m_out);
  zero_tail(dst, min(pos, m_out), m_out, t);
  if (t == 0) {
    out_lens[lane] = pos;
    if (pos > m_out || raw_bytes_len[lane] > m_raw) atomicOr(overflow, 1);
  }
}

}  // namespace

// out (S, m_out) needs no initialisation; overflow a zeroed int32.
extern "C" int vct_k8_pack_stuff(const int32_t* c_hi, const int32_t* c_lo,
                                 const int32_t* c_len,
                                 const int32_t* raw_bytes_len, int S, int K,
                                 int m_raw, int m_out, uint8_t* out,
                                 int32_t* out_lens, int32_t* overflow,
                                 void* stream) {
  if (S <= 0) return (int)cudaGetLastError();
  const int blocks = (S + kWarps - 1) / kWarps;
  pack_stuff_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      c_hi, c_lo, c_len, raw_bytes_len, S, K, m_raw, m_out, out, out_lens,
      overflow);
  return (int)cudaGetLastError();
}
