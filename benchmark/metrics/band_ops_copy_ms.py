"""Mean time per call the host waits for the banded route's ops (ms): the
program's ``seqalib.banded.ops_copy`` spans summed over a call's batches,
each the wait for the last super-block's recompute and walk on the card
and the copy of the batch's op matrix to the host."""

import marks


def read(window):
    return marks.mean_ms(window, "seqalib.banded.ops_copy")
