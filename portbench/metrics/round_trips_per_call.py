"""``round_trips_per_call``: the rounds the goal graphs ran over the window
(``ops.graph_loop.LAUNCHES["round_trips"]``: a stack's round once for all its
lanes), per entry call.  Layer: the device loop."""


def read(run):
    trips = run.counters.get("round_trips", 0)
    if not trips or not run.calls:
        return None
    return trips / len(run.calls)
