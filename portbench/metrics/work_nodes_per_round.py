"""``work_nodes_per_round``: the work nodes (kernels, memsets, copies) of
the captured rounds the graphs ran over the window
(``LAUNCHES["round_nodes"]``), per round.  Layer: the goal rounds."""


def read(run):
    trips = run.counters.get("round_trips", 0)
    if not trips:
        return None
    return run.counters.get("round_nodes", 0) / trips
