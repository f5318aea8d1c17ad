"""Mean time per call from the call's start to its first device op (ms):
the entry and dispatch layer's grouping, padding, letter staging and tables."""

import spans


def read(window):
    return spans.mean_part_ms(window, 0)
