"""queue_wait_p50_s.serve: the median wait of the window's requests
between submit and the start of their batch (``ServiceStats.queue_wait_p50``)."""


def read(run):
    stats = run.extra.get("service")
    return stats.queue_wait_p50 if stats is not None and stats.batches else None
