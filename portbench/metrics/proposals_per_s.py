"""``proposals_per_s``: proposals delivered in the window over the window's
seconds (host clock); a batched call delivers one proposal a lane."""


def read(run):
    if run.window_s <= 0:
        return None
    return sum(len(c.proposals) for c in run.calls) / run.window_s
