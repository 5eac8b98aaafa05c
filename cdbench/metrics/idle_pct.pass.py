"""idle_pct.pass: the share of the timed units' wall time in which no
operation ran on the device, from the profiler's trace."""


def read(run):
    return run.trace.idle_pct if run.trace is not None else None
