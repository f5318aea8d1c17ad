"""Mean time per call of the long pair's host staging before its first fill
launch (ms): the program's ``seqalib.sp.stage`` span (letter padding, the
boundary vectors and their uploads, the first row built on the card)."""

import marks


def read(window):
    return marks.mean_ms(window, "seqalib.sp.stage")
