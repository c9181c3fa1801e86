"""Huffman decode kernels (K1, K5, K6, K7 and the lookup table they
build): the least time for the frames' decode work (entropy bytes in,
int32 coefficients out, 40 operations a symbol) over the kernels' device
time, in percent of the roofline."""

from portbench import work

DECODE = {"huffman_decode_kernel", "huffman_decode_padded_kernel",
          "huffman_decode_streamed_kernel", "huffman_decode_staged_kernel"}
LUT = {"lut_level1_kernel", "lut_level2_kernel"}


def read(run):
    if run.trace is None or not run.sources:
        return None
    main = run.trace.kernels(DECODE)
    spent = sum(e - s for _n, s, e, _c, _k in main + run.trace.kernels(LUT))
    per = [work.huffman_decode(src, run.layout) for src in run.sources]
    mean = [(sum(b for b, _ in per) / len(per), sum(o for _, o in per)
             / len(per))]
    return work.roofline_pct(mean, len(main) * run.batch, spent / 1e6,
                             run.peaks)
