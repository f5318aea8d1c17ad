"""``sp_tile``'s share of its roofline (%): the least time of the
full-matrix work every call requires over the device time of every launch
of the tile kernel (``sp_run_kernel<MODE>``: 0 global and 1 local fills, 2
the traceback's pointer recompute).

A call requires a score fill of every pair's n x m cells and, with a
traceback, a pointer fill of them that writes their traceback bits
(``roofline.py``): the same rule as ``band_fill.roofline_pct``, whatever
cut of the matrix the program recomputes."""

import roofline

KERNEL = "sp_run_kernel<"


def read(window):
    least = spent = 0.0
    for call in window.calls:
        launches = [e - s for name, s, e in call.ops if KERNEL in name]
        if launches and call.work["band"] is None:
            spent += sum(launches) / 1e9
            for n, m in call.work["pairs"]:
                least += roofline.fill_s(n * m, n + m, 1)
                if call.work["traceback"]:
                    least += roofline.pointer_fill_s(n * m, n + m)
    return 100.0 * least / spent if spent else None
