"""Mean time per call of the long pair's host walk, without its pointer
batches (ms): the self time of the program's ``seqalib.sp.walk`` span, the
Python loop that follows the pointers from (n, m) back to (0, 0)."""

import marks


def read(window):
    return marks.mean_ms(window, "seqalib.sp.walk", self_time=True)
