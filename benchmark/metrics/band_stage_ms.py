"""Mean time per call of the banded route's host staging before its fill
(ms): the program's ``seqalib.banded.stage`` spans summed over a call's
batches (the pairs' band bounds, the letters padded and uploaded, the
score table and the starting state)."""

import marks


def read(window):
    return marks.mean_ms(window, "seqalib.banded.stage")
