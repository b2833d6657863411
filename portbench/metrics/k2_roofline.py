"""``k2_roofline``: K2 (``ops.segments.segment_sums`` with bool columns
only, the integer path) at the cell's snapshot rack-count call, its bytes
over 3.35 TB/s over its device time (``portbench/kernels.py``).  Timed after
the warm-up, before the window.  Layer: the segment-sum kernels."""

from portbench import kernels


def before_window(run):
    if run.device.type == "cuda":
        run.notes["k2"] = kernels.roofline(run, "k2")


def read(run):
    k = run.notes.get("k2")
    return None if k is None else k["pct"]
