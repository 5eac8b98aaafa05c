"""rechunk_s.pass: seconds a pass spends in the prologue's p-sorted
re-chunk (the program's ``prologue.rechunk`` span over ``engine_chunks``,
host clock; ``last_stats['rechunk_s']``), averaged over the window's
passes. None where the program records no such span."""


def read(run):
    vals = [u.stats["rechunk_s"] for u in run.done if "rechunk_s" in u.stats]
    return sum(vals) / len(vals) if vals else None
