"""Block datapath kernel (K2 decode): the least time for its work (int32
coefficients in, pixels out, 1,200 operations a block) over its device
time, in percent of the roofline."""

from portbench import work


def read(run):
    if run.trace is None:
        return None
    k2 = run.trace.kernels({"decode_datapath_kernel"})
    spent = sum(e - s for _n, s, e, _c, _k in k2)
    return work.roofline_pct([work.decode_datapath(run.layout)],
                             len(k2) * run.batch, spent / 1e6, run.peaks)
