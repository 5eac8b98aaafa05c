"""rescore_s.serve: seconds a served batch spends in the exact rescore of
its near-boundary pairs (the program's ``finalize.rescore`` spans, which
end with the rescore's device work): their seconds over the window
(``ServiceStats.span_s``) by its number of ``batch`` spans. None where
the program records no spans."""


def read(run):
    stats = run.extra.get("service")
    n = getattr(stats, "span_n", {}).get("batch", 0)
    return stats.span_s["finalize.rescore"] / n if n else None
