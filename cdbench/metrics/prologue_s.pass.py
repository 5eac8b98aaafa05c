"""prologue_s.pass: seconds a pass spends in the rest of the tiled prologue (chunking,
bucket deltas, tile pruning; ``last_stats['prologue_s']``), averaged over
the window's passes."""


def read(run):
    vals = [u.stats["prologue_s"] for u in run.done if "prologue_s" in u.stats]
    return sum(vals) / len(vals) if vals else None
