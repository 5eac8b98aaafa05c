"""rechunk_s.serve: seconds a served batch spends in the prologue's
p-sorted re-chunk (the program's ``prologue.rechunk`` spans, host clock):
their seconds over the window (``ServiceStats.span_s``) by its number of
``batch`` spans. None where the program records no spans."""


def read(run):
    stats = run.extra.get("service")
    n = getattr(stats, "span_n", {}).get("batch", 0)
    return stats.span_s["prologue.rechunk"] / n if n else None
