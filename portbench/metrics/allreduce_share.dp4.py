"""Rank 0's share of the traced steps' time in NCCL kernels, in %:
device time of kernels whose name holds 'nccl' over the traced part's
host clock."""


def read(ctx):
    t = ctx.trace
    if not t or not t.window_s or ctx.allreduce_s is None:
        return None
    return 100.0 * ctx.allreduce_s / t.window_s
