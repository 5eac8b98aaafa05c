"""commit_s.serve: seconds a served batch spends folding its rows into the
committed index and taking them out again (the program's ``serve.commit``
and ``serve.rollback`` spans, host clock): their seconds over the window
(``ServiceStats.span_s``) by its number of ``batch`` spans. None where the
program records no spans."""


def read(run):
    stats = run.extra.get("service")
    n = getattr(stats, "span_n", {}).get("batch", 0)
    if not n:
        return None
    return (stats.span_s["serve.commit"] + stats.span_s["serve.rollback"]) / n
