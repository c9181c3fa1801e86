"""Host entropy engine, from inside the port: milliseconds a frame in the
port's ``decode.destuff`` and ``decode.index_scan`` spans (one a frame
each, on the destuff and scan pools' threads) that start in the window.
The same calls as ``host_entropy.ms_per_frame`` times from outside."""

from portbench import program

SPANS = program.RECORDER


def read(run):
    destuff = program.window(run, "decode.destuff")
    if not destuff:
        return None
    scans = program.window(run, "decode.index_scan")
    return program.total_ms(destuff + scans) / len(destuff)
