"""index_build_sort_s.pass: seconds a pass spends in the index build's key
sort and ``unique`` (the program's ``index_build.sort`` span, host clock;
``last_stats['index_build_sort_s']``), averaged over the window's passes.
None where the program records no such span."""


def read(run):
    vals = [u.stats["index_build_sort_s"] for u in run.done
            if "index_build_sort_s" in u.stats]
    return sum(vals) / len(vals) if vals else None
