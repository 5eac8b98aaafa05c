"""b1_roofline_pct.pass: B1's share of its roofline over the window's
passes: the least time its launches need at the card's peaks
(``cdbench/roofline.py``, from each pass's shapes and counters) over the
device seconds of its kernel in the trace."""
from cdbench import roofline

KERNEL = "copyscore_fused_kernel"


def read(run):
    if run.trace is None:
        return None
    device_s = run.trace.kernel_s(KERNEL)
    if device_s <= 0:
        return None
    least = 0.0
    for u in run.done:
        least += roofline.least_seconds(*roofline.b1_pass(u.stats))[0]
    return 100.0 * least / device_s
