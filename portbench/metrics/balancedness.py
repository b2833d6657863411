"""``balancedness``: upstream's balancedness score of each proposal of the
window's first pass, worked out by the plain reference over the cell's goal
list from its own violation counts, averaged (each lane one proposal)."""

import math


def read(run):
    if not run.first_pass:
        return None
    return math.fsum(j.balancedness for j in run.first_pass) / len(run.first_pass)
