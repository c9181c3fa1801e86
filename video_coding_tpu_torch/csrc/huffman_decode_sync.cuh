// The self-synchronising decode of one padded row by one CTA (after
// Weißenberger & Schmidt, ICPP 2018), shared by K6 and K5's "row" regime.
// The two differ only in the reader: the peek16 of the reference's window
// array that each replaces (K6's RowReader, stride-16 windows; K5's
// PaddedReader, byte-granular ones).
//
// The row's data is cut into subsequences of U bits. The decoder state at
// a symbol boundary is (bit position, DC/AC phase, zigzag position, place
// of the block in the schedule's period P); a peek depends on the bit
// position only, so decoding from a state reads exactly what the
// sequential lane reads there.
//   1. Sync (sync_subsequences): subsequence u starts from a guessed state,
//      the one a decode begun warm bits earlier reaches at u·U, and runs up
//      to the first symbol boundary at or past (u+1)·U, its exit state,
//      counting the blocks whose DC symbol starts inside it and their DC
//      differences per component. Then, round after round, each
//      subsequence whose entry (its predecessor's exit) changed is decoded
//      again from it, until no exit changes. Subsequence 0 starts from the
//      true state, so the fixed point is the sequential decode; the worst
//      case is one subsequence a round, a sequential walk. P consecutive
//      blocks that consume no bits repeat forever (a failed DC match reads
//      nothing and a failed AC match is an EOB): such a subsequence owns
//      every later block, and the ones after it none.
//   2. Scan (scan_subsequences): exclusive prefix sums over the row's
//      subsequences of the block counts (saturating at B) and the DC sums
//      (int32, wrapping — the plain version's int64 sum cast to int32)
//      give each subsequence's first block index and DC predictors.
//   3. Write (write_subsequences): each thread decodes the blocks whose DC
//      symbol starts in its subsequences (past the end if need be; the
//      last subsequence is open) into its BlockBuf and writes each whole
//      as sixteen 16-byte stores.
// Each thread takes a run of consecutive subsequences, so a round carries
// a corrected state through all of them.

#pragma once

#include "huffman_decode_lut.cuh"

namespace vct {

constexpr unsigned long long kNever = 0x7FFFFFFFull << 32;
// per-row stats: sync rounds, subsequences, threads
constexpr int kSyncStats = 3;

__device__ inline unsigned long long sync_pack(int bitpos, bool in_ac,
                                               int cof, int place) {
  return ((unsigned long long)(unsigned)bitpos << 32) |
         ((unsigned long long)place << 8) | (unsigned)(cof << 1) |
         (unsigned)in_ac;
}

template <class Reader>
struct SyncRow {
  Reader rd;
  Tables tb;
  Lut lut;
  const uint8_t* staged;  // components of the first places, in shared memory
  const int32_t* sched;
  int C, P, B;
  __device__ int comp(int place) const {
    return sched_comp(staged, sched, place, C);
  }
  __device__ int next(int place) const { return place + 1 == P ? 0 : place + 1; }
};

// The per-subsequence records of one row: entry and exit states, block
// counts and DC sums (kMaxComponents a subsequence), in shared or global
// memory.
struct SubRecords {
  unsigned long long* entry;
  volatile unsigned long long* exit;
  int* cnt;
  int* dcs;
};

// bytes of the records of n subsequences, rounded up to a multiple of 16
__host__ __device__ inline size_t sub_record_bytes(int n) {
  return ((size_t)n * (2 * 8 + 4 + 4 * kMaxComponents) + 15) / 16 * 16;
}

__device__ inline SubRecords sub_records(void* base, int n) {
  auto* entry = static_cast<unsigned long long*>(base);
  auto* exit = entry + n;
  auto* cnt = reinterpret_cast<int*>(exit + n);
  return SubRecords{entry, exit, cnt, cnt + n};
}

// The schedule's smallest period P (sched[i] == sched[i + P] for all i);
// every thread of the CTA calls this.
__device__ inline int schedule_period(const uint8_t* s_comp,
                                      const int32_t* comp_sched, int B,
                                      int C) {
  for (int p = 1; p < B; ++p) {
    bool bad = false;
    for (int i = threadIdx.x; i + p < B && !bad; i += blockDim.x)
      bad = sched_comp(s_comp, comp_sched, i, C) !=
            sched_comp(s_comp, comp_sched, i + p, C);
    if (!__syncthreads_or(bad)) return p;
  }
  return B;
}

// Pass 1 for one subsequence: from entry state e up to the first symbol
// boundary at or past bit `end`. Returns the exit state; `cnt` and `dcs`
// get the blocks whose DC symbol starts before `end` and their DC sums.
template <class Reader>
__device__ unsigned long long sync_sub(SyncRow<Reader>& r,
                                       unsigned long long e, int end,
                                       int& cnt,
                                       int (&dcs)[kMaxComponents]) {
  cnt = 0;
#pragma unroll
  for (int c = 0; c < kMaxComponents; ++c) dcs[c] = 0;
  if (e == kNever) return kNever;
  int bitpos = (int)(e >> 32);
  int place = (int)((e >> 8) & 0xFFFFFF);
  int cof = (int)((e >> 1) & 0x7F);
  bool in_ac = e & 1;
  int comp = r.comp(place);
  int zstart = -1, zrun = 0;
  while (bitpos < end) {
    if (!in_ac) {
      // P blocks in a row that consumed no bits: the state repeats forever
      if (bitpos == zstart) {
        if (++zrun >= r.P) {
          cnt = r.B;
          return kNever;
        }
      } else {
        zstart = bitpos;
        zrun = 0;
      }
    }
    int used, run, cat, val;
    decode_symbol(r.rd, r.tb, r.lut, comp + (in_ac ? r.C : 0), in_ac, bitpos,
                  used, run, cat, val);
    bitpos += used;
    if (!in_ac) {
      ++cnt;
      add_dc(dcs, comp, val);
      in_ac = true;
      cof = 1;
    } else if ((run == 0 && cat == 0) || cof + run + 1 >= 64) {
      in_ac = false;
      cof = 0;
      place = r.next(place);
      comp = r.comp(place);
    } else {
      cof += run + 1;
    }
  }
  return sync_pack(bitpos, in_ac, cof, place);
}

// Pass 3 for one subsequence: finish the block that an earlier subsequence
// owns, then decode and write blocks blk.. while their DC symbol starts
// before `end` and blk < nblk.
template <class Reader>
__device__ void write_sub(SyncRow<Reader>& r, unsigned long long e, int end,
                          int blk, int (&dc)[kMaxComponents], int nblk,
                          BlockBuf& bb, int32_t* dst) {
  if (e == kNever || blk >= nblk) return;
  int bitpos = (int)(e >> 32);
  int place = (int)((e >> 8) & 0xFFFFFF);
  int cof = (int)((e >> 1) & 0x7F);
  bool in_ac = e & 1;
  int comp = r.comp(place);
  int used, run, cat, val;
  while (in_ac) {
    decode_symbol(r.rd, r.tb, r.lut, comp + r.C, true, bitpos, used, run,
                  cat, val);
    bitpos += used;
    if ((run == 0 && cat == 0) || cof + run + 1 >= 64) {
      in_ac = false;
      place = r.next(place);
      comp = r.comp(place);
    } else {
      cof += run + 1;
    }
  }
  while (blk < nblk && bitpos < end) {
    decode_symbol(r.rd, r.tb, r.lut, comp, false, bitpos, used, run, cat,
                  val);
    bitpos += used;
    const int dcw = add_dc(dc, comp, val);
    cof = 1;
    for (;;) {
      decode_symbol(r.rd, r.tb, r.lut, comp + r.C, true, bitpos, used, run,
                    cat, val);
      bitpos += used;
      if (run == 0 && cat == 0) break;  // EOB
      const int nc = cof + run;
      if (nc < 64 && val) bb.put(nc, val);
      if (nc + 1 >= 64) break;
      cof = nc + 1;
    }
    bb.flush(dst + (size_t)blk * 64, dcw);
    ++blk;
    place = r.next(place);
    comp = r.comp(place);
  }
}

// Pass 1 for the row: this thread's subsequences [u0, u1) of n_sub, round
// 0 and then rounds until no exit moves (every thread of the CTA calls
// this). Round 0 starts subsequence u from the state at u·U of a decode
// begun warm_bits earlier from a guess (or from the true start). Returns
// the rounds.
template <class Reader>
__device__ int sync_subsequences(SyncRow<Reader>& r, int U, int warm_bits,
                                 int n_sub, int u0, int u1,
                                 const SubRecords& rec) {
  for (int u = u0; u < u1; ++u) {
    int c = 0, d[kMaxComponents] = {0, 0, 0, 0};
    unsigned long long e = u == 0 ? 0ull : sync_pack(u * U, false, 0, 0);
    if (u > 0) {
      // a better guess: the state at u·U of a decode begun warm_bits
      // earlier from the same guess (or from the true start)
      int c_, d_[kMaxComponents];
      const int b0 = max(u * U - warm_bits, 0);
      const unsigned long long g = sync_sub(
          r, b0 == 0 ? 0ull : sync_pack(b0, false, 0, 0), u * U, c_, d_);
      if (g != kNever) e = g;
    }
    unsigned long long x = 0;
    if (u < n_sub - 1) x = sync_sub(r, e, (u + 1) * U, c, d);
    rec.entry[u] = e;
    rec.exit[u] = x;
    rec.cnt[u] = c;
    for (int k = 0; k < kMaxComponents; ++k)
      rec.dcs[u * kMaxComponents + k] = d[k];
  }
  int rounds = 1;
  for (;;) {
    __syncthreads();
    ++rounds;
    bool changed = false;
    for (int u = max(u0, 1); u < min(u1, n_sub - 1); ++u) {
      const unsigned long long e = rec.exit[u - 1];
      if (e == rec.entry[u]) continue;
      int c, d[kMaxComponents];
      const unsigned long long x = sync_sub(r, e, (u + 1) * U, c, d);
      rec.entry[u] = e;
      changed |= x != rec.exit[u];
      rec.exit[u] = x;
      rec.cnt[u] = c;
      for (int k = 0; k < kMaxComponents; ++k)
        rec.dcs[u * kMaxComponents + k] = d[k];
    }
    if (!__syncthreads_or(changed)) break;
  }
  return rounds;
}

// Pass 2: exclusive prefix of the block counts (saturating at B) and the
// DC sums over the n_sub subsequences, in place (every thread of the CTA
// of kThreads calls this; s_tot is shared).
template <int kThreads>
__device__ void scan_subsequences(int n_sub, int B, const SubRecords& rec,
                                  int (*s_tot)[kMaxComponents + 1]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int carry[kMaxComponents + 1] = {0, 0, 0, 0, 0};
  for (int base = 0; base < n_sub; base += kThreads) {
    const int u = base + tid;
    int v[kMaxComponents + 1] = {0, 0, 0, 0, 0};
    if (u < n_sub) {
      v[0] = min(rec.cnt[u], B);
      for (int k = 0; k < kMaxComponents; ++k)
        v[k + 1] = rec.dcs[u * kMaxComponents + k];
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
      for (int k = 0; k <= kMaxComponents; ++k) {
        const int w = __shfl_up_sync(~0u, v[k], o);
        if (lane >= o)
          v[k] = k ? (int)((unsigned)v[k] + (unsigned)w) : min(v[k] + w, B);
      }
    }
    if (lane == 31)
      for (int k = 0; k <= kMaxComponents; ++k) s_tot[warp][k] = v[k];
    __syncthreads();
#pragma unroll
    for (int k = 0; k <= kMaxComponents; ++k) {
      int excl = __shfl_up_sync(~0u, v[k], 1);
      if (lane == 0) excl = 0;
      int add = carry[k], tot = carry[k];
      for (int w = 0; w < kThreads / 32; ++w) {
        const int t = s_tot[w][k];
        if (w < warp)
          add = k ? (int)((unsigned)add + (unsigned)t) : min(add + t, B);
        tot = k ? (int)((unsigned)tot + (unsigned)t) : min(tot + t, B);
      }
      v[k] = k ? (int)((unsigned)add + (unsigned)excl) : min(add + excl, B);
      carry[k] = tot;
    }
    if (u < n_sub) {
      rec.cnt[u] = v[0];
      for (int k = 0; k < kMaxComponents; ++k)
        rec.dcs[u * kMaxComponents + k] = v[k + 1];
    }
    __syncthreads();
  }
}

// Pass 3: this thread's subsequences, each block whole into dst (the
// row's (B, 64) output), after scan_subsequences.
template <class Reader>
__device__ void write_subsequences(SyncRow<Reader>& r, int U, int n_sub,
                                   int u0, int u1, int nblk,
                                   const SubRecords& rec, BlockBuf& bb,
                                   int32_t* dst) {
  for (int u = u0; u < u1; ++u) {
    int dc[kMaxComponents];
    for (int k = 0; k < kMaxComponents; ++k)
      dc[k] = rec.dcs[u * kMaxComponents + k];
    write_sub(r, u == 0 ? 0ull : rec.exit[u - 1],
              u == n_sub - 1 ? INT_MAX : (u + 1) * U, rec.cnt[u], dc, nblk,
              bb, dst);
  }
}

// Blocks [nblk, B) of a row's output as zeros, 16 bytes a store (every
// thread of the CTA calls this).
__device__ inline void zero_blocks_past(int32_t* dst, int nblk, int B) {
  int4* z = reinterpret_cast<int4*>(dst + (size_t)nblk * 64);
  for (int i = threadIdx.x; i < (B - nblk) * 16; i += blockDim.x)
    z[i] = make_int4(0, 0, 0, 0);
}

}  // namespace vct
