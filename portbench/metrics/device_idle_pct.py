"""``device_idle_pct``: the share of the traced pass in which the device ran
nothing, 100 x (1 - busy / window): busy where a goal graph's CUDA-event
window or a traced device operation runs (``portbench/trace.py``).  A graph
window counts the gaps between its nodes as busy, so this is a floor on the
idle share.  Layer: the device."""


def read(run):
    r = run.reading
    if r is None or r.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
