"""The median time of a window's training step in ms (host clock around
`train_step_shared`, which ends in the host's read of its metrics)."""
import statistics


def read(ctx):
    return statistics.median(ctx.step_s) * 1e3 if ctx.step_s else None
