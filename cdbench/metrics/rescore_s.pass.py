"""rescore_s.pass: seconds a pass spends in the exact rescore of its near-boundary pairs
(``last_stats['rescore_s']``), averaged over the window's passes. The
program's clock stops before a synchronize, so it can miss the tail of
the launch queue; the pass itself ends in a copy to the host."""


def read(run):
    vals = [u.stats["rescore_s"] for u in run.done if "rescore_s" in u.stats]
    return sum(vals) / len(vals) if vals else None
