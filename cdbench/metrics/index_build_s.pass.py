"""index_build_s.pass: seconds a pass spends building the inverted index (the engine's
``last_stats['index_build_s']``, host clock), averaged over the window's
passes."""


def read(run):
    vals = [u.stats["index_build_s"] for u in run.done if "index_build_s" in u.stats]
    return sum(vals) / len(vals) if vals else None
