"""device.idle_share: the share of the traced window, in %, in which no
kernel, copy or memset ran on the card."""
from mcbench import devtrace


def read(view):
    if view.trace is None:
        return None
    w = devtrace.window_s(view.trace)
    return 100.0 * (1.0 - devtrace.busy_s(view.trace) / w) if w > 0 else None
