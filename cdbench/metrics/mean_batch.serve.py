"""mean_batch.serve: requests a batched engine pass answered over the
window (``ServiceStats.mean_batch``)."""


def read(run):
    stats = run.extra.get("service")
    return stats.mean_batch if stats is not None and stats.batches else None
