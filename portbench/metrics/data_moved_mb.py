"""``data_moved_mb``: the inter-broker data a proposal moves, the disk load
of every replica whose broker changed, summed exactly by the reference;
averaged over the proposals of the window's first pass."""

import math


def read(run):
    if not run.first_pass:
        return None
    return math.fsum(j.data_moved for j in run.first_pass) / len(run.first_pass)
