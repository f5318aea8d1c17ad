"""Mean time per call the host waits for the walk's pointer rows (ms): the
program's ``seqalib.sp.ptr_copy`` spans summed over a call's batches, each
the wait for its recompute on the card and the copy of its rows to the
host."""

import marks


def read(window):
    return marks.mean_ms(window, "seqalib.sp.ptr_copy")
