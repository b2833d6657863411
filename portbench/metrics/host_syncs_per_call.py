"""``host_syncs_per_call``: the host waits an entry call reports
(``num_host_syncs`` of ``OptimizerResult`` / ``BatchedResult``), averaged
over the window's calls.  Layer: the analyzer's optimizer."""


def read(run):
    if not run.calls:
        return None
    return sum(c.num_host_syncs for c in run.calls) / len(run.calls)
