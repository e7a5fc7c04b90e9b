"""The median latency of the window's frames in ms (host clock, from a
frame's `frame_async` call to its uint8 image on the host)."""
import statistics


def read(ctx):
    return statistics.median(ctx.lat) * 1e3 if ctx.lat else None
