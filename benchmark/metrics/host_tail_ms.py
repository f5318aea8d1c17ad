"""Mean time per call from its last device op's end to its return (ms): the
host work after the card's last op (walks, CIGARs, result objects)."""

import spans


def read(window):
    return spans.mean_part_ms(window, 2)
