"""``graph_device_ms_per_call``: the device time of an entry call's goal
graphs, from the program's own CUDA events around each graph launch
(``graph_device_s`` of its ``optimize`` record), averaged over the window's
untraced calls (``portbench/flight.py``).  Layer: the device loop."""

from portbench import flight


def read(run):
    return flight.mean_ms(r.attrs["graph_device_s"]
                          for r in flight.window_records(run) if r.attrs.get("graph_device_s") is not None)
