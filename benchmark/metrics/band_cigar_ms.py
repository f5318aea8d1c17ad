"""Mean time per call of the banded route's CIGAR text (ms): the program's
``seqalib.banded.cigar`` spans summed over a call's batches, the op
matrix run-length encoded on the host and the results built."""

import marks


def read(window):
    return marks.mean_ms(window, "seqalib.banded.cigar")
