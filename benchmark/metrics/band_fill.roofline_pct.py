"""``band_fill``'s share of its roofline (%): the least time of the banded
fills every call requires over the device time of every ``band_fill`` launch.

A call requires a score fill of every pair's band and, with a traceback,
the checkpointed recompute of the band with its pointer bytes
(``roofline.py``).  The launches are the device ops whose name holds
``band_fill``; the work is the call's, whatever launches the program
splits it into."""

import reference
import roofline


def least_s(work):
    cells = sum(reference.band_cells(n, m, work["band"]) for n, m in work["pairs"])
    letters = sum(n + m for n, m in work["pairs"])
    s = roofline.fill_s(cells, letters, len(work["pairs"]))
    if work["traceback"]:
        s += roofline.pointer_fill_s(cells, letters)
    return s


def read(window):
    least = spent = 0.0
    for call in window.calls:
        launches = [e - s for name, s, e in call.ops if "band_fill" in name]
        if launches and call.work["band"] is not None:
            spent += sum(launches) / 1e9
            least += least_s(call.work)
    return 100.0 * least / spent if spent else None
