// K4 — the whole baseline entropy encoder, kGroup lanes a restart segment:
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
//   and leave the DC predictors alone. The wrapper zero-fills the slots:
//   the stuffed 0x00 after a 0xFF, and the slot past the segment's bytes,
//   are never written.
//
// What bounds it on an H100: bytes. At the main path's shape (130,560
//   segments of 6 blocks) it reads 200 MB of coefficients, ~60 us at
//   3.35 TB/s; a block holds a few symbols, so the code that finds and
//   places them has to stay short enough to hide behind the loads.
//
// What the design does about it: one thread a segment (the TPU kernel's
//   lane FSM) walked every zero before a block's last nonzero, read its
//   own 1.5 KB row with 32 lanes 1.5 KB apart and wrote bytes one at a
//   time. Here a group of kGroup lanes owns a segment, and a warp runs
//   32 / kGroup segments side by side, block by block, so the fixed cost of
//   a pass, a flush and a segment's end is shared. Per-lane work on every
//   coefficient would cost as much for a block of zeros as for a dense
//   one, so the lanes only find the symbols block by block and code them
//   kGroup at a time:
//   - the segments' coefficients come into shared memory kAhead blocks at
//     a time with 16-byte cp.async copies, two stages in flight;
//   - per block, lane l of a group reads coefficients l + kGroup * r; one
//     ballot per r gives the block's nonzero mask, and each symbol gets its
//     place in the segment's order from popcounts of that mask: lane 0 the
//     DC (its difference against the component's predictor, kept in
//     shared memory), each lane with a nonzero AC coefficient its value
//     and run (from __clzll of the mask below it), the last lane the EOB
//     when coefficient 63 is zero. They go into the segment's ring of
//     kRing descriptors;
//   - whenever a segment holds kGroup symbols, every group codes up to
//     kGroup of its own, one a lane: run >> 4 ZRL codes, then the code at
//     (run & 15) * 11 + size (size saturates at 11: below run 15 that reads
//     the next run's size-0 entry, at run 15 it is past the table and
//     reads 0) and the magnitude bits; a scan over the group gives the bit
//     offsets, and the lanes OR their bits into the segment's big-endian
//     buffer of kBufWords words;
//   - when a buffer could not take another pass, and at the segment's end,
//     its complete bytes are stuffed: each lane takes a word, counts its
//     0xFF bytes, a scan over the group gives the output positions, and
//     the lanes store their bytes into the slot; the partial byte stays,
//     and the cursor counts on past m_out.
//
// Alignment: the coefficients are copied in 16-byte pieces, so they must
// start on a 16-byte boundary (the wrapper raises otherwise).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 16;            // lanes a segment
constexpr int kSegs = 32 / kGroup;    // segments a warp
constexpr int kWarps = 4;             // warps a CTA
constexpr int kThreads = kWarps * 32;
constexpr int kMaxComponents = 4;
constexpr int kAhead = 2;             // blocks a segment a copy stage
constexpr int kPer = 64 / kGroup;     // coefficients a lane a block
constexpr int kStage = kAhead * 64 + kGroup;  // a segment's stage, padded
constexpr int kRing = 128;            // symbol descriptors a segment
constexpr int kBufWords = 128;        // a segment's bit buffer
constexpr int kBufBits = kBufWords * 32;
// one pass's bits at most, with the final 1-bit pad: kGroup symbols of a
// 31-bit code, 11 magnitude bits and 3 ZRLs of 31 bits, 7 pad bits
constexpr int kMaxPassBits = 16 * 42 + 16 * 3 * 31 + 7;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kAc = 0, kDc = 1 << 8, kEob = 2 << 8;

static_assert(kMaxPassBits == kGroup * (42 + 3 * 31) + 7, "kMaxPassBits");
static_assert(kMaxPassBits < kBufBits, "bit buffer too small");
static_assert(kRing >= kGroup - 1 + 64, "ring must take a block");

struct __align__(16) WarpSmem {
  int32_t coef[2][kSegs][kStage];
  int2 ring[kSegs][kRing];
  uint32_t buf[kSegs][kBufWords];
  int pred[kSegs][kMaxComponents];
};

__device__ __forceinline__ void cp_async16(void* smem_dst,
                                           const void* gmem_src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem_src)
               : "memory");
}

// inclusive sum over the lane's group of kGroup lanes
__device__ __forceinline__ int group_inclusive_sum(int x, int l) {
#pragma unroll
  for (int d = 1; d < kGroup; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d, kGroup);
    if (l >= d) x += y;
  }
  return x;
}

__device__ __forceinline__ int group_total(int incl) {
  return __shfl_sync(kFull, incl, kGroup - 1, kGroup);
}

// OR the low len bits of val (0 <= len <= 64) into the big-endian bit
// buffer at bit offset off
__device__ __forceinline__ void put_bits(uint32_t* buf, int off, uint64_t val,
                                         int len) {
  if (len <= 0) return;
  const uint64_t x = val << (64 - len);
  const uint32_t hi = (uint32_t)(x >> 32), lo = (uint32_t)x;
  const int w = off >> 5, s = off & 31;
  atomicOr(buf + w, hi >> s);
  if (s + len > 32) atomicOr(buf + w + 1, __funnelshift_r(lo, hi, s));
  if (s + len > 64) atomicOr(buf + w + 2, lo << (32 - s));
}

// size category of v >= 0, saturating at 11 (the reference's 11-term sum)
__device__ __forceinline__ int size_category(int v) {
  const int bits = 32 - __clz(v);
  return bits < 11 ? bits : 11;
}

// stuff and store the complete bytes of the group's buffer when ``need``
// (group-uniform; every lane of the warp calls it); the partial byte
// moves to the buffer's start
__device__ __forceinline__ void flush(uint32_t* buf, bool need, int& bitpos,
                                      int& outpos, uint8_t* dst, int m_out,
                                      int l) {
  __syncwarp();
  const int nbytes = need ? bitpos >> 3 : 0;
  const int nwords = need ? (bitpos + 31) >> 5 : 0;
  const uint32_t tail =
      need && (nbytes >> 2) < kBufWords ? buf[nbytes >> 2] : 0u;
  const int most = __reduce_max_sync(kFull, nwords);
  for (int w0 = 0; w0 < most; w0 += kGroup) {
    const int i = w0 + l;
    const uint32_t word = i < nwords ? buf[i] : 0u;
    const int nb = min(max(nbytes - 4 * i, 0), 4);
    int count = nb;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      count += k < nb && ((word >> (24 - 8 * k)) & 0xFF) == 0xFF;
    const int incl = group_inclusive_sum(count, l);
    int p = outpos + incl - count;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < nb) {
        const uint32_t byte = (word >> (24 - 8 * k)) & 0xFF;
        if (p < m_out) dst[p] = (uint8_t)byte;
        p += 1 + (byte == 0xFF);
      }
    }
    outpos += group_total(incl);
  }
  __syncwarp();
  for (int i = l; i < nwords; i += kGroup) buf[i] = 0u;
  __syncwarp();
  if (need && l == 0) buf[0] = (tail << (8 * (nbytes & 3))) & 0xFF000000u;
  if (need) bitpos &= 7;
  __syncwarp();
}

// code up to kGroup of the oldest symbols of each group's ring, one a
// lane (every lane of the warp calls it)
__device__ __forceinline__ void code_pass(uint32_t* buf, const int2* ring,
                                          int& head, int& count, int& bitpos,
                                          int& outpos, const int32_t* s_dc,
                                          const int32_t* s_ac, uint8_t* dst,
                                          int m_out, int l) {
  __syncwarp();
  flush(buf, bitpos > kBufBits - kMaxPassBits, bitpos, outpos, dst, m_out,
        l);
  const int n = min(count, kGroup);
  uint64_t val = 0;
  int len = 0, nzrl = 0, zpk = 0;
  if (l < n) {
    const int2 d = ring[(head + l) & (kRing - 1)];
    const int v = d.x, kind = d.y & 0xFF00, run = d.y & 0xFF;
    const int32_t* acrow = s_ac + (d.y >> 16) * 176;
    const int size = kind == kEob ? 0 : size_category(v < 0 ? -v : v);
    const int idx = kind == kAc ? (run & 15) * 11 + size : 0;
    const int pk = kind == kDc ? s_dc[(d.y >> 16) * 12 + size]
                   : idx < 176 ? acrow[idx] : 0;
    val = ((uint64_t)((uint32_t)pk >> 5) << size) |
          ((uint32_t)(v >= 0 ? v : v - 1) & ((1u << size) - 1));
    len = (pk & 31) + size;
    if (kind == kAc) {
      nzrl = run >> 4;
      zpk = acrow[15 * 11];
    }
  }
  const int zlen = zpk & 31;
  const int bits = len + nzrl * zlen;
  const int incl = group_inclusive_sum(bits, l);
  int off = bitpos + incl - bits;
  for (int k = 0; k < nzrl; ++k, off += zlen)
    put_bits(buf, off, (uint32_t)zpk >> 5, zlen);
  put_bits(buf, off, val, len);
  bitpos += group_total(incl);
  head += n;
  count -= n;
}

__global__ void __launch_bounds__(kThreads) huffman_encode_kernel(
    const int32_t* __restrict__ qc, const uint8_t* __restrict__ valid,
    int S, int B, const int32_t* __restrict__ comp_sched, int C,
    const int32_t* __restrict__ dctab_g, const int32_t* __restrict__ actab_g,
    int m_out, uint8_t* __restrict__ out, int32_t* __restrict__ lens,
    int32_t* __restrict__ overflow) {
  __shared__ int32_t s_dc[kMaxComponents * 12];
  __shared__ int32_t s_ac[kMaxComponents * 176];
  __shared__ WarpSmem s_warp[kWarps];
  for (int i = threadIdx.x; i < C * 12; i += kThreads) s_dc[i] = dctab_g[i];
  for (int i = threadIdx.x; i < C * 176; i += kThreads) s_ac[i] = actab_g[i];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane / kGroup, l = lane % kGroup;
  WarpSmem& w = s_warp[warp];
  uint32_t* buf = w.buf[g];
  int2* ring = w.ring[g];
  for (int i = l; i < kBufWords; i += kGroup) buf[i] = 0u;
  if (l < kMaxComponents) w.pred[g][l] = 0;
  __syncthreads();

  const int first = (blockIdx.x * kWarps + warp) * kSegs;
  if (first >= S) return;
  const int seg = first + g;
  const bool live = seg < S;
  uint8_t* dst = out + (size_t)seg * m_out;
  const int shift = kGroup * g;
  int bitpos = 0, outpos = 0, head = 0, count = 0;

  // copy stage: blocks b0 .. b0 + kAhead - 1 of each live segment; the
  // lane's valid flag of block b0 + l beside
  auto stage = [&](int b0, int st) {
    const int pieces = min(kAhead, B - b0) * 16;
    if (live)
      for (int i = l; i < pieces; i += kGroup)
        cp_async16(&w.coef[st][g][i * 4],
                   qc + ((size_t)seg * B + b0) * 64 + i * 4);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    return live && l < kAhead && b0 + l < B &&
           valid[(size_t)seg * B + b0 + l] != 0;
  };
  bool v_cur = B > 0 && stage(0, 0);
  for (int b0 = 0, st = 0; b0 < B; b0 += kAhead, st ^= 1) {
    bool v_next = false;
    if (b0 + kAhead < B) v_next = stage(b0 + kAhead, st ^ 1);
    else asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncwarp();
    // bit kGroup * g + k of vmask: block b0 + k of group g's segment is
    // valid
    const uint32_t vmask = __ballot_sync(kFull, v_cur);
#pragma unroll 1
    for (int k = 0; k < kAhead && b0 + k < B; ++k) {
      const bool on = (vmask >> (shift + k)) & 1;
      const int32_t* blk = &w.coef[st][g][k * 64];
      int c[kPer];
#pragma unroll
      for (int r = 0; r < kPer; ++r) c[r] = on ? blk[l + kGroup * r] : 0;
      // the block's nonzero mask: bit l + kGroup * r from lane l's c[r];
      // position 0 counts as nonzero: it is the DC symbol, and runs start
      // after it
      uint64_t mask = 1;
#pragma unroll
      for (int r = 0; r < kPer; ++r)
        mask |= (uint64_t)((__ballot_sync(kFull, c[r] != 0) >> shift) &
                           ((1ull << kGroup) - 1))
                << (kGroup * r);
      if (on) {
        // schedule entries past the tables clamp to the last component
        // (the sessions never produce them)
        const int comp = min(max(__ldg(comp_sched + b0 + k), 0), C - 1);
        const int tag = comp << 16;
        const int base = head + count;
        if (l == 0) {
          // DC: difference against the component's predictor
          ring[base & (kRing - 1)] = make_int2(c[0] - w.pred[g][comp],
                                               kDc | tag);
          w.pred[g][comp] = c[0];
        }
#pragma unroll
        for (int r = 0; r < kPer; ++r) {
          const int j = l + kGroup * r;
          if (j > 0 && c[r] != 0) {
            const uint64_t prev = mask & ((1ull << j) - 1);
            ring[(base + __popcll(prev)) & (kRing - 1)] =
                make_int2(c[r], kAc | tag | (j - 1 - (63 - __clzll(prev))));
          }
        }
        const int n = __popcll(mask);
        if (l == kGroup - 1 && c[kPer - 1] == 0)
          ring[(base + n) & (kRing - 1)] = make_int2(0, kEob | tag);
        count += n + !(mask >> 63);
      }
      while (__any_sync(kFull, count >= kGroup))
        code_pass(buf, ring, head, count, bitpos, outpos, s_dc, s_ac, dst,
                  m_out, l);
    }
    __syncwarp();
    v_cur = v_next;
  }
  while (__any_sync(kFull, count > 0))
    code_pass(buf, ring, head, count, bitpos, outpos, s_dc, s_ac, dst,
              m_out, l);
  // flush to a byte boundary with 1-bits
  __syncwarp();
  const int pad = (-bitpos) & 7;
  if (live && l == 0) put_bits(buf, bitpos, (1u << pad) - 1, pad);
  bitpos += pad;
  flush(buf, live, bitpos, outpos, dst, m_out, l);
  if (live && l == 0) {
    lens[seg] = outpos;
    if (outpos > m_out) atomicOr(overflow, 1);
  }
}

}  // namespace

extern "C" int vct_k4_huffman_encode(
    const int32_t* qc, const uint8_t* valid, int S, int B,
    const int32_t* comp_sched, int C, const int32_t* dctab,
    const int32_t* actab, int m_out, uint8_t* out, int32_t* lens,
    int32_t* overflow, void* stream) {
  if (S <= 0) return (int)cudaGetLastError();
  const int per_cta = kWarps * kSegs;
  const int blocks = (S + per_cta - 1) / per_cta;
  huffman_encode_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      qc, valid, S, B, comp_sched, C, dctab, actab, m_out, out, lens,
      overflow);
  return (int)cudaGetLastError();
}
