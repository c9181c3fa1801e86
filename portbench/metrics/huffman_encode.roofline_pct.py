"""Huffman encode kernels (K4, or K9 and K8 where the packer routes a
dispatch to the split path): the least time for the window's entropy
encode work (int32 coefficients in, the output's entropy bytes out, 30
operations a symbol; the symbols those of the reference's output) over
the kernels' device time, in percent of the roofline. The frames are the
encode datapath's (K3) launches, one a dispatch, times the frames a
dispatch: a rung that overflowed counts its time and no frames."""

from portbench import work, work_encode

ENCODE = {"huffman_encode_kernel", "pack_stuff_kernel",
          "table_lookup_kernel"}


def read(run):
    if run.trace is None or not run.expected:
        return None
    spent = sum(e - s for _n, s, e, _c, _k in run.trace.kernels(ENCODE))
    frames = len(run.trace.kernels({"encode_datapath_kernel"})) * run.batch
    per = [work_encode.huffman_encode(out, run.layout)
           for out in run.expected]
    mean = [(sum(b for b, _ in per) / len(per), sum(o for _, o in per)
             / len(per))]
    return work.roofline_pct(mean, frames, spent / 1e6, run.peaks)
