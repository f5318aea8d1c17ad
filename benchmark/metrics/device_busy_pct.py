"""Share of the traced window in which any op (kernel, copy, set) ran on the
device (%): the union of their intervals over the window's wall."""

import spans


def read(window):
    if not window.ops:
        return None
    return 100.0 * spans.union_ns([(s, e) for _, s, e in window.ops]) / (window.end - window.start)
