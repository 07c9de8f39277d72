"""device.idle_share: the share of the traced window in which no kernel,
copy or memset ran on the card: 1 - (union of their intervals) / window,
from the first call's start to the last call's end. In %."""


def read(ctx):
    window = ctx.trace.window()
    if window is None or not ctx.trace.device or window[1] <= window[0]:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_us() / (window[1] - window[0]))
