"""``snapshot_wall_ms_per_call``: the host's wall in an entry call spent in
the eager snapshots and violation passes outside the goal graphs (the
``snapshot`` and ``violations`` spans of its ``optimize`` record, summed),
averaged over the window's untraced calls (``portbench/flight.py``).  The
wall holds the time the host sat blocked launching those kernels behind a
full launch queue too, so it is the snapshots' host cost only on a
host-paced call.  Layer: the analyzer's context, the snapshots taken outside
the graphs."""

from portbench import flight

SPANS = ("snapshot", "violations")


def _children(span):
    """A span's children; none where the program's spans have no such field."""
    return getattr(span, "children", None) or []


def _walk(spans):
    for s in spans:
        yield s
        yield from _walk(_children(s))


def read(run):
    return flight.mean_ms(sum(s.duration_s for s in _walk(r.spans) if s.name in SPANS)
                          for r in flight.window_records(run) if any(_children(s) for s in r.spans))
