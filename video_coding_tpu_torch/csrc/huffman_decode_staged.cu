// K7 — K1 fed by asynchronous copies into shared memory that the kernel
// starts itself, one thread per segment.
//
// Replaces: video_coding_tpu/entropy/pallas_decode.py _kernel_t_dma (the
//   pallas_call in decode_flat_pallas_dma). Same contract as K1, start-state
//   hooks included, and the same result bit for bit: the lane's bytes are
//   taken as 16-byte rows from the 16-byte-aligned row starts[s] >> 4 of
//   the flat buffer, the <= 15 bytes of slack before the segment ride the
//   initial bit cursor and the effective length, bytes at or past the
//   effective length read as zero, then K1's symbol loop runs on the copy.
//
// What bounds it on an H100: as K1, latency of a serial automaton per lane;
//   the copies move the ~3 MB of compressed input once.
//
// What the design does about it: the counterpart of the TPU kernel's
//   per-lane DMA is cp.async (16 bytes, global → shared, no registers in
//   between). Each thread starts the copies of its own lane's rows into its
//   own slots, waits for its own group, and then reads only those slots, so
//   no CTA barrier is needed. Slots are interleaved (row r of thread t at
//   slot r·threads + t), so a warp's copies and reads are neighbours. The
//   buffer holds `rows` rows a lane, sized by the launcher from the longest
//   lane of the batch (lanes are length-sorted, so a CTA's lanes need about
//   the same) and capped; a lane longer than the buffer loads its next
//   wave of rows when the byte cursor leaves the current one.

#include "huffman_decode_common.cuh"

namespace {

using namespace vct;

constexpr int kThreads = 128;
constexpr int kMaxRows = 32;  // 512 bytes a lane, 64 KB a CTA

__device__ inline void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem_src)
               : "memory");
}

__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

struct StagedFetch {
  const uint8_t* flat;  // 16-byte aligned
  long long n_rows;     // 16-byte rows in flat
  long long row0;       // the lane's first row
  int len_eff;          // slack + segment length, in bytes from row0
  uint8_t* stage;       // the CTA's staging buffer
  int rows;             // rows a lane in one wave
  int wbase = 0, wend = 0;  // lane-local byte range now staged

  __device__ uint8_t* slot(int r) const {
    return stage + ((size_t)r * blockDim.x + threadIdx.x) * 16;
  }

  __device__ void load(int p) {
    const int wbytes = rows * 16;
    wbase = p / wbytes * wbytes;
    wend = wbase + wbytes;
    for (int r = 0; r < rows && wbase + r * 16 < len_eff; ++r) {
      const long long row = row0 + (wbase >> 4) + r;
      if (row < n_rows)
        cp_async16(slot(r), flat + row * 16);
      else
        *reinterpret_cast<int4*>(slot(r)) = make_int4(0, 0, 0, 0);
    }
    cp_async_wait_all();
  }

  __device__ uint64_t operator()(int p) {
    if (p >= len_eff) return 0ull;  // zero past the lane's end
    if (p >= wend) load(p);
    const int q = p - wbase;
    return (uint64_t)slot(q >> 4)[q & 15];
  }
};

__global__ void huffman_decode_staged_kernel(
    const uint8_t* __restrict__ flat, long long n_rows,
    const int32_t* __restrict__ starts, const int32_t* __restrict__ lens,
    const int32_t* __restrict__ seg_blocks, int S,
    const int32_t* __restrict__ comp_sched, int B, int C,
    const int32_t* __restrict__ lo_g, const int32_t* __restrict__ hi_g,
    const int32_t* __restrict__ off_g, int T,
    const int32_t* __restrict__ values_g, int V, int max_steps,
    const int32_t* __restrict__ init_bitpos,
    const int32_t* __restrict__ init_dc, int rows,
    int32_t* __restrict__ out) {
  extern __shared__ int32_t smem[];
  const Tables tb = stage_tables(smem, lo_g, hi_g, off_g, T, values_g, V);

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= S) return;
  const int start = starts[lane];
  const int slack = start & 15;
  StagedFetch fetch{flat,
                    n_rows,
                    start >> 4,
                    lens[lane] + slack,
                    reinterpret_cast<uint8_t*>(smem + table_ints(T, V)),
                    rows};
  decode_lane_stream(fetch, tb, comp_sched, min(seg_blocks[lane], B), C,
                     max_steps,
                     8 * slack + (init_bitpos ? init_bitpos[lane] : 0),
                     init_dc ? init_dc + (size_t)lane * C : nullptr,
                     out + (size_t)lane * B * 64);
}

}  // namespace

// flat must be 16-byte aligned and flat_len a multiple of 16. L is the
// batch's lane-length bucket (>= the longest lane); it only sizes the
// staging buffer. init_bitpos / init_dc may be null.
extern "C" int vct_k7_huffman_decode_staged(
    const uint8_t* flat, long long flat_len, const int32_t* starts,
    const int32_t* lens, const int32_t* seg_blocks, int S,
    const int32_t* comp_sched, int B, int C, const int32_t* lo,
    const int32_t* hi, const int32_t* offset, int T, const int32_t* values,
    int V, int max_steps, const int32_t* init_bitpos, const int32_t* init_dc,
    int L, int32_t* out, void* stream) {
  if (S <= 0) return (int)cudaGetLastError();
  int rows = (L + 15 + 15) / 16;  // slack + longest lane
  rows = rows < 1 ? 1 : (rows > kMaxRows ? kMaxRows : rows);
  const int blocks = (S + kThreads - 1) / kThreads;
  const size_t smem = table_ints(T, V) * sizeof(int32_t) +
                      (size_t)rows * kThreads * 16;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(huffman_decode_staged_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  huffman_decode_staged_kernel<<<blocks, kThreads, smem,
                                 (cudaStream_t)stream>>>(
      flat, flat_len / 16, starts, lens, seg_blocks, S, comp_sched, B, C, lo,
      hi, offset, T, values, V, max_steps, init_bitpos, init_dc, rows, out);
  return (int)cudaGetLastError();
}
