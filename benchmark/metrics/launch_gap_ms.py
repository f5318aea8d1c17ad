"""Mean device idle time per call between its first and last device op (ms):
the host drivers' launch gaps, host work between copies, and syncs."""

import spans


def read(window):
    return spans.mean_part_ms(window, 1)
