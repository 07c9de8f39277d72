"""trials_per_s: the trials of every call completed in the window over the
seconds from the window's start to the last completion."""


def read(ctx):
    if ctx.window_s is None or ctx.window_s <= 0:
        return None
    return sum(c["trials"] for c in ctx.calls) / ctx.window_s
