"""``host_outside_waits_ms_per_call``: the host's wall in an entry call
outside its explicit waits on the device, the call's wall less the seconds
spent in the host syncs (``duration_s - host_wait_s`` of the program's
``optimize`` record), averaged over the window's untraced calls
(``portbench/flight.py``).  Not the host's busy time: a host blocked inside a
launch (a graph launch, a full launch queue) counts here, so on a
device-paced call this reads near the call's whole wall.  Layer: the
analyzer's optimizer, the host driver of the solve."""

from portbench import flight


def read(run):
    return flight.mean_ms(r.duration_s - r.attrs["host_wait_s"]
                          for r in flight.window_records(run) if "host_wait_s" in r.attrs)
