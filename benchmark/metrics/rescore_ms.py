"""Mean time per call of the long pair's re-score and CIGAR text (ms): the
program's ``seqalib.sp.rescore`` span, from the walk's ops to the result."""

import marks


def read(window):
    return marks.mean_ms(window, "seqalib.sp.rescore")
