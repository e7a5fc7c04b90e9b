"""The device's idle share of the traced frames, in %: 1 - (union of
the CUDA intervals) / (host clock over the traced part)."""


def read(ctx):
    t = ctx.trace
    if not t or not t.window_s or not t.busy_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
