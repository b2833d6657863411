"""``k1_roofline``: K1 (``ops.segments.segment_sums`` with float
columns) at the cell's snapshot broker call, its bytes over 3.35 TB/s over
its device time (``portbench/kernels.py``).  Timed after the warm-up,
before the window.  Layer: the segment-sum kernels."""

from portbench import kernels


def before_window(run):
    if run.device.type == "cuda":
        run.notes["k1"] = kernels.roofline(run, "k1")


def read(run):
    k = run.notes.get("k1")
    return None if k is None else k["pct"]
