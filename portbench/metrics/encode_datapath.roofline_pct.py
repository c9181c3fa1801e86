"""Block datapath kernel of the encoder (K3): the least time for its work
(8-bit pixels in, int32 coefficients out, 1,100 operations a block) over
its device time, in percent of the roofline."""

from portbench import work, work_encode


def read(run):
    if run.trace is None:
        return None
    k3 = run.trace.kernels({"encode_datapath_kernel"})
    spent = sum(e - s for _n, s, e, _c, _k in k3)
    return work.roofline_pct([work_encode.encode_datapath(run.layout)],
                             len(k3) * run.batch, spent / 1e6, run.peaks)
