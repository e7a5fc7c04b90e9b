"""Test-only metric: the frames the window served."""


def read(ctx):
    return len(ctx.hits) or None
