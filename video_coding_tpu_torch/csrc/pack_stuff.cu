// K8 — the split entropy encoder's bit packer, one thread per restart
// segment: symbol slots (hi, lo, length) in, stuffed wire bytes out.
//
// Replaces: video_coding_tpu/entropy/pallas_encode.py _kernel (the
//   pallas_call in pack_stuff_pallas). Same contract: per lane, for
//   k = 0..K-1 the low c_len[k] bits of the 64-bit value
//   (c_hi[k] << 32) | c_lo[k] are appended MSB-first (bits at or above the
//   length may be garbage and are masked; a zero length is a no-op), each
//   completed byte is written at the lane's cursor, and after a 0xFF byte
//   the cursor advances one more — the stuffed 0x00 is the untouched zero
//   of the zero-initialised output. A byte whose cursor is at or past m_out
//   is dropped while the cursor goes on counting. out_lens is the final
//   cursor; overflow is set when a lane's raw_bytes_len exceeds m_raw or
//   its cursor ends past m_out. Lengths are clamped to 0..59.
//
// What bounds it on an H100: bytes. The three (S, K) int32 slot arrays are
//   611 MB at S = 16,320 lanes of K = 3,121 slots (a 16-frame 1080p
//   dispatch with 48 blocks a segment) against ~21 MB of output; the
//   per-lane work is a short dependent chain a slot, and most slots are
//   empty.
//
// What the design does about it: with one thread a lane and row-major
//   (S, K) inputs, a warp's 32 lanes sit K·4 bytes apart, so a direct load
//   would fetch one 32-byte sector for every 4 bytes used. Instead a CTA is
//   one warp that owns 32 lanes and walks k in tiles of 32 slots: for each
//   of its lanes the warp copies the tile's 32 consecutive ints with one
//   coalesced 128-byte cp.async request (4 bytes a thread, no registers in
//   between) into a padded shared-memory tile [lane][33], which each
//   thread then reads along its own lane without bank conflicts. Two tile
//   buffers alternate, so the copies of tile t+1 are in flight while tile t
//   is packed. The TPU kernel's sublane-major (K, CHUNK) layout, int32-pair
//   accumulator, one-hot byte writes into a word-packed grid and fixed
//   4-pass drain are Mosaic's and are not carried: a slot of up to 59 bits
//   goes into a 64-bit register accumulator as two pieces of at most 32
//   bits (7 pending + 32 never exceeds 39), and bytes go straight to the
//   lane's own output slot.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;      // lanes a CTA (one warp)
constexpr int kTile = 32;       // slots a tile
constexpr int kPitch = kTile + 1;
constexpr int kMaxSlotBits = 59;

__device__ __forceinline__ void cp_async4(void* smem_dst,
                                          const void* gmem_src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct BitSink {
  uint64_t acc;
  int nbits;
  int pos;
  int m_out;
  uint8_t* out;

  // append the low len bits of val, 1 <= len <= 32 (val already masked)
  __device__ __forceinline__ void put(uint32_t val, int len) {
    acc = (acc << len) | (uint64_t)val;
    nbits += len;
    while (nbits >= 8) {
      const uint32_t byte = (uint32_t)(acc >> (nbits - 8)) & 0xFF;
      if (pos < m_out) out[pos] = (uint8_t)byte;
      pos += 1 + (byte == 0xFF);
      nbits -= 8;
    }
  }
};

struct Tile {
  int32_t hi[kLanes][kPitch];
  int32_t lo[kLanes][kPitch];
  int32_t len[kLanes][kPitch];
};

__global__ void __launch_bounds__(kLanes) pack_stuff_kernel(
    const int32_t* __restrict__ c_hi, const int32_t* __restrict__ c_lo,
    const int32_t* __restrict__ c_len,
    const int32_t* __restrict__ raw_bytes_len, int S, int K, int m_raw,
    int m_out, uint8_t* __restrict__ out, int32_t* __restrict__ out_lens,
    int32_t* __restrict__ overflow) {
  __shared__ Tile tiles[2];
  const int t = threadIdx.x;
  const int lane0 = blockIdx.x * kLanes;
  const int lane = lane0 + t;
  const int lanes_here = min(kLanes, S - lane0);
  const bool live = lane < S;

  // thread t copies slot k0 + t of every lane of the CTA
  auto issue = [&](int tile_no) {
    Tile& tl = tiles[tile_no & 1];
    const int k = tile_no * kTile + t;
    if (k < K) {
      for (int l = 0; l < lanes_here; ++l) {
        const size_t src = (size_t)(lane0 + l) * K + k;
        cp_async4(&tl.hi[l][t], c_hi + src);
        cp_async4(&tl.lo[l][t], c_lo + src);
        cp_async4(&tl.len[l][t], c_len + src);
      }
    }
    cp_async_commit();
  };

  BitSink sink{0ull, 0, 0, m_out,
               out + (size_t)(live ? lane : 0) * m_out};
  const int n_tiles = (K + kTile - 1) / kTile;
  if (n_tiles > 0) issue(0);
  for (int tile_no = 0; tile_no < n_tiles; ++tile_no) {
    if (tile_no + 1 < n_tiles) {
      issue(tile_no + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    if (live) {
      const Tile& tl = tiles[tile_no & 1];
      const int kmax = min(kTile, K - tile_no * kTile);
      for (int k = 0; k < kmax; ++k) {
        const int len = min(max(tl.len[t][k], 0), kMaxSlotBits);
        if (len == 0) continue;
        uint64_t v = ((uint64_t)(uint32_t)tl.hi[t][k] << 32) |
                     (uint64_t)(uint32_t)tl.lo[t][k];
        v &= (1ull << len) - 1;
        if (len > 32) sink.put((uint32_t)(v >> 32), len - 32);
        sink.put((uint32_t)v, len < 32 ? len : 32);
      }
    }
    __syncwarp();  // the tile is free before its buffer is filled again
  }
  if (!live) return;
  out_lens[lane] = sink.pos;
  if (sink.pos > m_out || raw_bytes_len[lane] > m_raw) atomicOr(overflow, 1);
}

}  // namespace

// out must be zero-initialised (S, m_out); overflow a zeroed int32.
extern "C" int vct_k8_pack_stuff(const int32_t* c_hi, const int32_t* c_lo,
                                 const int32_t* c_len,
                                 const int32_t* raw_bytes_len, int S, int K,
                                 int m_raw, int m_out, uint8_t* out,
                                 int32_t* out_lens, int32_t* overflow,
                                 void* stream) {
  if (S <= 0) return (int)cudaGetLastError();
  const int blocks = (S + kLanes - 1) / kLanes;
  pack_stuff_kernel<<<blocks, kLanes, 0, (cudaStream_t)stream>>>(
      c_hi, c_lo, c_len, raw_bytes_len, S, K, m_raw, m_out, out, out_lens,
      overflow);
  return (int)cudaGetLastError();
}
