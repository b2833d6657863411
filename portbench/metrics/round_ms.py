"""``round_ms``: the goal graphs' device time (CUDA events around each
``GoalGraph.launch``) over the rounds they ran, in the passes of a traced
run's window after its traced pass, which the profiler slows.  Layer: the
device loop."""


def read(run):
    if run.graph_s is None or not run.graph_trips:
        return None
    return run.graph_s * 1e3 / run.graph_trips
