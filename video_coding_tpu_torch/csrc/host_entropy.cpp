// Host entropy engine of the PyTorch port (video_coding_tpu_torch).
//
// A copy of the JAX package's C++ engine (native/entropy.cpp), with the
// same entry points, semantics, 8-component limit and ABI version: the
// host-side hot path of baseline JPEG Huffman decode and encode over
// restart-interval segments, multithreaded (segments are independent by
// construction — DC predictors reset at every RSTn), plus the destuff,
// lane-pack, index-scan and stream-assembly passes.
//
// Semantics are bit-identical to the golden Python model
// (video_coding_tpu_torch/model/decoder.py, encoder.py), which in turn
// mirrors the reference OCaml model (jpeg/model/src/decoder.ml:73-140,
// encoder.ml:127-193) and bitstream writer stuffing rules
// (common/src/bitstream_writer.ml:19-49).
//
// Build: g++ -O3 -std=c++17 -fPIC -shared -pthread (no external deps);
// video_coding_tpu_torch/entropy/native.py builds it at first use.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#include <algorithm>
#include <atomic>

namespace {

// ---------------------------------------------------------------------------
// Bit reader: MSB-first over a byte buffer, zero-fill past the end
// (mirrors common/src/bitstream_reader.ml get_byte returning '\000').
// ---------------------------------------------------------------------------
struct BitReader {
  const uint8_t* p;
  int64_t len;        // bytes
  uint64_t buf = 0;   // MSB-aligned low bits: next bit = (buf >> (cnt-1)) & 1
  int cnt = 0;        // valid bits in buf
  int64_t bytepos = 0;

  BitReader(const uint8_t* data, int64_t n) : p(data), len(n) {}

  inline void refill() {
    while (cnt <= 56) {
      uint8_t b = bytepos < len ? p[bytepos] : 0;
      ++bytepos;
      buf = (buf << 8) | b;
      cnt += 8;
    }
  }

  inline uint32_t peek(int n) {
    refill();
    return (uint32_t)((buf >> (cnt - n)) & ((1u << n) - 1));
  }

  inline void consume(int n) { cnt -= n; }

  inline uint32_t get(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    cnt -= n;
    return v;
  }
};

// Magnitude (sign extension) decode: decoder.ml:73-79.
inline int32_t magnitude(int cat, uint32_t code) {
  if (cat == 0) return 0;
  if (code & (1u << (cat - 1))) return (int32_t)code;
  return (int32_t)(code | (~0u << cat)) + 1;
}

struct CompLut {
  const int32_t* dc;   // 2^dc_maxbits entries, (length<<16)|data
  int dc_maxbits;
  const int32_t* ac;
  int ac_maxbits;
};

// Decode one segment's blocks. Returns 0 or negative error (-(block+1)).
// With check_overrun (resync mode), consuming bits past the segment's real
// data is an error too — the block decoded zero-fill garbage.
int64_t decode_segment(const uint8_t* data, int64_t data_len,
                       const int32_t* comp_idx, int64_t first_block,
                       int64_t n_blocks_seg, int n_components,
                       const CompLut* luts, int32_t* out_coefs,
                       bool check_overrun = false) {
  BitReader br(data, data_len);
  int32_t dc_pred[8] = {0};
  for (int64_t b = 0; b < n_blocks_seg; ++b) {
    int64_t blk = first_block + b;
    int c = comp_idx[blk];
    if (c < 0 || c >= n_components) return -(blk + 1);
    const CompLut& lut = luts[c];
    int32_t* coefs = out_coefs + blk * 64;
    // DC
    int32_t e = lut.dc[br.peek(lut.dc_maxbits)];
    int len = e >> 16;
    if (len == 0) return -(blk + 1);
    br.consume(len);
    int cat = e & 0xffff;
    if (cat > 15) return -(blk + 1);  // malformed LUT entry
    int32_t diff = magnitude(cat, br.get(cat));
    dc_pred[c] += diff;
    coefs[0] = dc_pred[c];
    // ACs
    int cof = 1;
    while (cof < 64) {
      e = lut.ac[br.peek(lut.ac_maxbits)];
      len = e >> 16;
      if (len == 0) return -(blk + 1);
      br.consume(len);
      int run = (e >> 4) & 0xf;
      int size = e & 0xf;
      int32_t val = magnitude(size, br.get(size));
      if (val == 0 && run == 0) break;  // EOB
      cof += run;
      if (cof >= 64) return -(blk + 1);
      coefs[cof++] = val;
    }
    // consumed bits = fetched - buffered (prefetch-independent)
    if (check_overrun && br.bytepos * 8 - br.cnt > data_len * 8)
      return -(blk + 1);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Bit writer: MSB-first with JPEG 0xFF00 stuffing
// (mirrors common/src/bitstream_writer.ml).
// ---------------------------------------------------------------------------
struct BitWriter {
  uint8_t* out;
  int64_t cap;
  int64_t n = 0;      // bytes written
  uint64_t buf = 0;   // pending bits (low-aligned)
  int cnt = 0;

  BitWriter(uint8_t* o, int64_t c) : out(o), cap(c) {}

  inline bool put(uint32_t value, int bits) {
    if (bits == 0) return true;
    buf = (buf << bits) | (value & ((1u << bits) - 1));
    cnt += bits;
    while (cnt >= 8) {
      uint8_t d = (uint8_t)((buf >> (cnt - 8)) & 0xff);
      if (n >= cap) return false;
      out[n++] = d;
      cnt -= 8;
      if (d == 0xff) {
        if (n >= cap) return false;
        out[n++] = 0;  // stuffing
      }
    }
    return true;
  }

  inline bool flush_with_1s() {
    while (cnt & 7) {
      if (!put(1, 1)) return false;
    }
    return true;
  }
};

// Encoder error codes (distinct so callers can report the real cause;
// see video_coding_tpu_torch/entropy/scan.py encode_scan_stream).
constexpr int64_t VCT_EOVERFLOW = -1;   // output buffer too small
constexpr int64_t VCT_ECOMP = -2;       // comp_idx out of range
constexpr int64_t VCT_ERANGE = -3;      // coefficient beyond 12-bit range

struct CompEncTables {
  const uint16_t* dc_bits;  // [12]
  const uint8_t* dc_len;    // [12]
  const uint16_t* ac_bits;  // [16*11], run*11+size
  const uint8_t* ac_len;
};

inline int size_category(int32_t v) {
  uint32_t a = v < 0 ? (uint32_t)(-v) : (uint32_t)v;
  return a == 0 ? 0 : 32 - __builtin_clz(a);
}

inline uint32_t magnitude_bits(int size, int32_t v) {
  uint32_t mask = (1u << size) - 1;
  return (v >= 0 ? (uint32_t)v : (uint32_t)(v - 1)) & mask;
}

// Encode one segment. Returns bytes written or a negative error:
//   VCT_EOVERFLOW  output buffer too small (retry with a larger one)
//   VCT_ECOMP      comp_idx entry outside [0, n_components)
//   VCT_ERANGE     coefficient outside the baseline 12-bit magnitude range
// Templated on the coefficient type: the device download is int16 (the
// quantized range is ±2047), so accepting it directly skips a whole-array
// int32 conversion on the host.
template <typename T>
int64_t encode_segment(const T* qcoefs, const int32_t* comp_idx,
                       int64_t first_block, int64_t n_blocks_seg,
                       int n_components, const CompEncTables* tabs,
                       uint8_t* out, int64_t out_cap) {
  BitWriter w(out, out_cap);
  int32_t dc_pred[8] = {0};
  for (int64_t b = 0; b < n_blocks_seg; ++b) {
    int64_t blk = first_block + b;
    int c = comp_idx[blk];
    if (c < 0 || c >= n_components) return VCT_ECOMP;
    const CompEncTables& t = tabs[c];
    const T* q = qcoefs + blk * 64;
    // DC: differential, size category + magnitude (encoder.ml:149-161)
    int32_t dc = q[0];
    int32_t diff = dc - dc_pred[c];
    dc_pred[c] = dc;
    int size = size_category(diff);
    if (size > 11) return VCT_ERANGE;
    if (!w.put(t.dc_bits[size], t.dc_len[size])) return VCT_EOVERFLOW;
    if (!w.put(magnitude_bits(size, diff), size)) return VCT_EOVERFLOW;
    // ACs: run-length + ZRL splitting + EOB (encoder.ml:163-193)
    int last_nz = 0;
    for (int i = 63; i >= 1; --i) {
      if (q[i] != 0) { last_nz = i; break; }
    }
    if (last_nz == 0) {
      if (!w.put(t.ac_bits[0], t.ac_len[0])) return VCT_EOVERFLOW;  // EOB
      continue;
    }
    int run = 0;
    for (int i = 1; i <= last_nz; ++i) {
      int32_t v = q[i];
      if (v == 0) { ++run; continue; }
      while (run >= 16) {
        if (!w.put(t.ac_bits[15 * 11], t.ac_len[15 * 11])) return VCT_EOVERFLOW;  // ZRL
        run -= 16;
      }
      int s = size_category(v);
      if (s > 10) return VCT_ERANGE;
      int idx = run * 11 + s;
      if (!w.put(t.ac_bits[idx], t.ac_len[idx])) return VCT_EOVERFLOW;
      if (!w.put(magnitude_bits(s, v), s)) return VCT_EOVERFLOW;
      run = 0;
    }
    if (last_nz < 63) {
      if (!w.put(t.ac_bits[0], t.ac_len[0])) return VCT_EOVERFLOW;  // EOB
    }
  }
  if (!w.flush_with_1s()) return VCT_EOVERFLOW;
  return w.n;
}

// Run `work(s)` over all segments, optionally on a small thread pool.
template <typename F>
void parallel_for_segments(int64_t n_segments, int n_threads, F work) {
  if (n_threads <= 1 || n_segments == 1) {
    for (int64_t s = 0; s < n_segments; ++s) work(s);
    return;
  }
  int nt = std::min<int64_t>(n_threads, n_segments);
  std::vector<std::thread> threads;
  std::atomic<int64_t> next{0};
  for (int t = 0; t < nt; ++t) {
    threads.emplace_back([&]() {
      for (;;) {
        int64_t s = next.fetch_add(1);
        if (s >= n_segments) break;
        work(s);
      }
    });
  }
  for (auto& t : threads) t.join();
}

}  // namespace

extern "C" {

// Decode all segments of a scan into (n_blocks, 64) int32 zigzag
// coefficients with DC prediction resolved. out_coefs must be
// zero-initialized. Returns 0 on success or -(failing_block+1).
int64_t vct_decode_blocks(
    const uint8_t* data,                 // concatenated destuffed segments
    const int64_t* seg_offsets,          // [n_segments+1] byte offsets
    int64_t n_segments,
    const int32_t* comp_idx,             // [n_blocks]
    int64_t n_blocks,
    int64_t blocks_per_segment,          // blocks in each segment (last may be short)
    int32_t n_components,
    const int32_t* dc_maxbits,           // [n_components]
    const int32_t* dc_lut,               // concatenated per-component
    const int64_t* dc_lut_off,           // [n_components+1]
    const int32_t* ac_maxbits,
    const int32_t* ac_lut,
    const int64_t* ac_lut_off,
    int32_t* out_coefs,
    int32_t n_threads) {
  if (n_components > 8) return -1000000000;
  std::vector<CompLut> luts(n_components);
  for (int c = 0; c < n_components; ++c) {
    luts[c].dc = dc_lut + dc_lut_off[c];
    luts[c].dc_maxbits = dc_maxbits[c];
    luts[c].ac = ac_lut + ac_lut_off[c];
    luts[c].ac_maxbits = ac_maxbits[c];
  }
  std::atomic<int64_t> err{0};
  auto work = [&](int64_t s) {
    int64_t first = s * blocks_per_segment;
    int64_t count = std::min(blocks_per_segment, n_blocks - first);
    if (count <= 0) return;
    int64_t r = decode_segment(data + seg_offsets[s],
                               seg_offsets[s + 1] - seg_offsets[s], comp_idx,
                               first, count, n_components, luts.data(),
                               out_coefs);
    if (r != 0) {
      int64_t expected = 0;
      err.compare_exchange_strong(expected, r);
    }
  };
  parallel_for_segments(n_segments, n_threads, work);
  return err.load();
}

// Resync (error-concealment) decode: like vct_decode_blocks, but a decode
// error inside a segment conceals that segment instead of aborting the
// scan — the failing block and every later block of the segment stay
// all-zero coefficients (the valid prefix is kept). This is the restart-
// marker resynchronization the JPEG standard provides and the reference
// leaves TODO (jpeg/README.md:36): segments are independent, so damage
// cannot propagate past the next RSTn.
// seg_status[s] = 0 (clean) or -(failing_block+1). Returns the number of
// damaged segments (>= 0), or a negative hard error.
int64_t vct_decode_blocks_resync(
    const uint8_t* data,
    const int64_t* seg_offsets,
    int64_t n_segments,
    const int32_t* comp_idx,
    int64_t n_blocks,
    int64_t blocks_per_segment,
    int32_t n_components,
    const int32_t* dc_maxbits,
    const int32_t* dc_lut,
    const int64_t* dc_lut_off,
    const int32_t* ac_maxbits,
    const int32_t* ac_lut,
    const int64_t* ac_lut_off,
    int32_t* out_coefs,
    int64_t* seg_status,
    int32_t n_threads) {
  if (n_components > 8) return -1000000000;
  std::vector<CompLut> luts(n_components);
  for (int c = 0; c < n_components; ++c) {
    luts[c].dc = dc_lut + dc_lut_off[c];
    luts[c].dc_maxbits = dc_maxbits[c];
    luts[c].ac = ac_lut + ac_lut_off[c];
    luts[c].ac_maxbits = ac_maxbits[c];
  }
  std::atomic<int64_t> n_damaged{0};
  auto work = [&](int64_t s) {
    int64_t first = s * blocks_per_segment;
    int64_t count = std::min(blocks_per_segment, n_blocks - first);
    if (count <= 0) { seg_status[s] = 0; return; }
    int64_t r = decode_segment(data + seg_offsets[s],
                               seg_offsets[s + 1] - seg_offsets[s], comp_idx,
                               first, count, n_components, luts.data(),
                               out_coefs, /*check_overrun=*/true);
    seg_status[s] = r;
    if (r != 0) {
      // conceal the failing block (possibly partially written) onward
      int64_t bad = -r - 1;
      std::memset(out_coefs + bad * 64, 0,
                  (size_t)(first + count - bad) * 64 * sizeof(int32_t));
      n_damaged.fetch_add(1);
    }
  };
  parallel_for_segments(n_segments, n_threads, work);
  return n_damaged.load();
}

// Index a single entropy segment (typically a foreign, restart-free
// stream) for parallel decode: walk the symbol stream WITHOUT writing
// coefficients, recording at every `stride`-block boundary the absolute
// bit position and the running DC predictors. The records turn one
// serial segment into ceil(n_blocks/stride) independent "virtual
// segments" — each device lane starts at its recorded bit offset with
// its recorded predictors and decodes bit-exactly (the deterministic
// form of speculative intra-segment parallel decode; the index pass
// skips the coefficient writes, so it is cheaper than a full decode).
// Returns 0 or -(failing_block+1).
int64_t vct_index_scan(
    const uint8_t* data, int64_t data_len,
    const int32_t* comp_idx, int64_t n_blocks,
    int32_t n_components,
    const int32_t* dc_maxbits, const int32_t* dc_lut,
    const int64_t* dc_lut_off,
    const int32_t* ac_maxbits, const int32_t* ac_lut,
    const int64_t* ac_lut_off,
    int64_t stride,
    int64_t* bit_offsets,      // [ceil(n_blocks/stride)]
    int32_t* dc_preds) {       // [ceil(n_blocks/stride) * 8]
  if (n_components > 8) return -1000000000;
  std::vector<CompLut> luts(n_components);
  for (int c = 0; c < n_components; ++c) {
    luts[c].dc = dc_lut + dc_lut_off[c];
    luts[c].dc_maxbits = dc_maxbits[c];
    luts[c].ac = ac_lut + ac_lut_off[c];
    luts[c].ac_maxbits = ac_maxbits[c];
  }
  BitReader br(data, data_len);
  int32_t dc_pred[8] = {0};
  int64_t rec = 0;
  for (int64_t blk = 0; blk < n_blocks; ++blk) {
    if (blk % stride == 0) {
      bit_offsets[rec] = br.bytepos * 8 - br.cnt;  // consumed bits
      for (int c = 0; c < 8; ++c) dc_preds[rec * 8 + c] = dc_pred[c];
      ++rec;
    }
    int c = comp_idx[blk];
    if (c < 0 || c >= n_components) return -(blk + 1);
    const CompLut& lut = luts[c];
    int32_t e = lut.dc[br.peek(lut.dc_maxbits)];
    int len = e >> 16;
    if (len == 0) return -(blk + 1);
    br.consume(len);
    int cat = e & 0xffff;
    if (cat > 15) return -(blk + 1);
    dc_pred[c] += magnitude(cat, br.get(cat));
    int cof = 1;
    while (cof < 64) {
      e = lut.ac[br.peek(lut.ac_maxbits)];
      len = e >> 16;
      if (len == 0) return -(blk + 1);
      br.consume(len);
      int run = (e >> 4) & 0xf;
      int size = e & 0xf;
      uint32_t code = br.get(size);
      if (size == 0 && run == 0) break;  // EOB
      (void)code;
      cof += run + 1;
      if (cof > 64) return -(blk + 1);
    }
  }
  return 0;
}

}  // extern "C"

namespace {

// Encode all segments of a scan. Each segment s writes its stuffed,
// 1-padded bytes at out + s*seg_stride; seg_lens[s] receives its length.
// Returns 0 on success, -1 on buffer overflow or out-of-range input
// (coefficients beyond the baseline 12-bit magnitude range).
template <typename T>
int64_t encode_blocks_impl(
    const T* qcoefs,                     // [n_blocks*64] zigzag
    const int32_t* comp_idx,
    int64_t n_blocks,
    int64_t blocks_per_segment,
    int64_t n_segments,
    int32_t n_components,
    const uint16_t* dc_bits,             // [n_components*12]
    const uint8_t* dc_len,
    const uint16_t* ac_bits,             // [n_components*176]
    const uint8_t* ac_len,
    uint8_t* out,
    int64_t seg_stride,
    int64_t* seg_lens,
    int32_t n_threads) {
  if (n_components > 8) return -1000000000;
  std::vector<CompEncTables> tabs(n_components);
  for (int c = 0; c < n_components; ++c) {
    tabs[c].dc_bits = dc_bits + c * 12;
    tabs[c].dc_len = dc_len + c * 12;
    tabs[c].ac_bits = ac_bits + c * 176;
    tabs[c].ac_len = ac_len + c * 176;
  }
  std::atomic<int64_t> err{0};
  auto work = [&](int64_t s) {
    int64_t first = s * blocks_per_segment;
    int64_t count = std::min(blocks_per_segment, n_blocks - first);
    if (count <= 0) { seg_lens[s] = 0; return; }
    int64_t r = encode_segment(qcoefs, comp_idx, first, count, n_components,
                               tabs.data(), out + s * seg_stride, seg_stride);
    if (r < 0) {
      int64_t expected = 0;
      err.compare_exchange_strong(expected, r);
      seg_lens[s] = 0;
    } else {
      seg_lens[s] = r;
    }
  };
  parallel_for_segments(n_segments, n_threads, work);
  return err.load();
}

}  // namespace

extern "C" {

int64_t vct_encode_blocks(
    const int32_t* qcoefs, const int32_t* comp_idx,
    int64_t n_blocks, int64_t blocks_per_segment, int64_t n_segments,
    int32_t n_components,
    const uint16_t* dc_bits, const uint8_t* dc_len,
    const uint16_t* ac_bits, const uint8_t* ac_len,
    uint8_t* out, int64_t seg_stride, int64_t* seg_lens,
    int32_t n_threads) {
  return encode_blocks_impl(qcoefs, comp_idx, n_blocks, blocks_per_segment,
                            n_segments, n_components, dc_bits, dc_len,
                            ac_bits, ac_len, out, seg_stride, seg_lens,
                            n_threads);
}

// int16 variant: consumes the device's int16 coefficient download with no
// host-side widening pass.
int64_t vct_encode_blocks_i16(
    const int16_t* qcoefs, const int32_t* comp_idx,
    int64_t n_blocks, int64_t blocks_per_segment, int64_t n_segments,
    int32_t n_components,
    const uint16_t* dc_bits, const uint8_t* dc_len,
    const uint16_t* ac_bits, const uint8_t* ac_len,
    uint8_t* out, int64_t seg_stride, int64_t* seg_lens,
    int32_t n_threads) {
  return encode_blocks_impl(qcoefs, comp_idx, n_blocks, blocks_per_segment,
                            n_segments, n_components, dc_bits, dc_len,
                            ac_bits, ac_len, out, seg_stride, seg_lens,
                            n_threads);
}

// Compact strided segments into one contiguous entropy body with RSTn
// markers interleaved (segment i>0 is preceded by FFD0+((i-1)&7)) —
// the byte layout the encoder session splices between its headers and
// EOI. Returns bytes written to dst (caller sizes dst >= sum(lens) +
// 2*(n_segments-1)).
int64_t vct_assemble_stream(
    const uint8_t* segs, int64_t seg_stride, const int64_t* seg_lens,
    int64_t n_segments, uint8_t* dst) {
  int64_t o = 0;
  for (int64_t s = 0; s < n_segments; ++s) {
    if (s > 0) {
      dst[o++] = 0xff;
      dst[o++] = (uint8_t)(0xd0 + ((s - 1) & 7));
    }
    std::memcpy(dst + o, segs + s * seg_stride, (size_t)seg_lens[s]);
    o += seg_lens[s];
  }
  return o;
}

// Remove 0x00 stuffing after 0xFF and split at RSTn markers.
// Writes destuffed bytes to out (caller sizes out >= data_len), fills
// seg_ends with the end offset (in out) of each segment and, when
// seg_markers is non-null, the RSTn modulo-8 index terminating each
// segment (the last segment has no terminator; its slot is -1). Returns
// the number of segments, or -1 if more than max_segments.
int64_t vct_destuff_segments_m(
    const uint8_t* data, int64_t data_len,
    uint8_t* out, int64_t* seg_ends, int64_t* seg_markers,
    int64_t max_segments) {
  int64_t o = 0;
  int64_t nseg = 0;
  int64_t i = 0;
  while (i < data_len) {
    uint8_t b = data[i];
    if (b != 0xff) {
      out[o++] = b;
      ++i;
      continue;
    }
    uint8_t m = (i + 1 < data_len) ? data[i + 1] : 0xd9;
    if (m == 0x00) {
      out[o++] = 0xff;
      i += 2;
    } else if (m >= 0xd0 && m <= 0xd7) {  // RSTn
      if (nseg >= max_segments) return -1;
      if (seg_markers) seg_markers[nseg] = m & 7;
      seg_ends[nseg++] = o;
      i += 2;
    } else if (m == 0xff) {
      ++i;  // fill byte
    } else {
      break;  // other marker terminates the scan
    }
  }
  if (nseg >= max_segments) return -1;
  if (seg_markers) seg_markers[nseg] = -1;
  seg_ends[nseg++] = o;
  return nseg;
}

int64_t vct_destuff_segments(
    const uint8_t* data, int64_t data_len,
    uint8_t* out, int64_t* seg_ends, int64_t max_segments) {
  return vct_destuff_segments_m(data, data_len, out, seg_ends, nullptr,
                                max_segments);
}

// Pack segments of the flat destuffed buffer into a fixed-stride lane
// matrix (row i = segment order[i], zero-padded by the caller's zeroed
// allocation). The host-side replacement for the device's per-lane
// gather: an XLA row gather costs ~0.6 us per LANE on the target chip
// (~4.5 ms at 8k lanes/frame) while this strided memcpy is ~0.1 ms.
void vct_pack_lanes(const uint8_t* flat, const int64_t* starts,
                    const int64_t* lens, const int32_t* order,
                    int64_t n_segments, int64_t stride, uint8_t* out) {
  for (int64_t i = 0; i < n_segments; ++i) {
    int64_t s = order ? order[i] : i;
    std::memcpy(out + i * stride, flat + starts[s], (size_t)lens[s]);
  }
}

int32_t vct_version() { return 7; }

}  // extern "C"
