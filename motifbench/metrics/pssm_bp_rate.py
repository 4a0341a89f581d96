"""PSSMs in the database times the bases of every scan that completed in
the window, over the window's seconds, in billions: all of the window's
work over all of its time."""


def read(run):
    return run.pssms * sum(s["bp"] for s in run.scans) / run.window_s / 1e9
