"""batch_s.serve: the mean seconds of the window's served batches (the
program's ``batch`` spans, host clock: cache lookups, the transient
commit, the engine pass, the rollback and the responses; their seconds
and count by name in ``ServiceStats.span_s`` / ``span_n``). None where
the program records no spans."""


def read(run):
    stats = run.extra.get("service")
    n = getattr(stats, "span_n", {}).get("batch", 0)
    return stats.span_s["batch"] / n if n else None
