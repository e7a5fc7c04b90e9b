"""K3a's (`folded_bwd_direct_kernel` and `folded_bwd_coarse_kernel`, the
table scatter of the hash backward) share of its roofline, in %: per
traced step, the batch's points (every ray x samples) x (L*C + 3)
float32 read plus the table's gradient written once (the bound: bytes),
over 3.35 TB/s, divided by the kernels' device time in the trace."""
from portbench import yardstick


def read(ctx):
    t = ctx.trace.kernel_s(r'folded_bwd_(direct|coarse)_kernel') \
        if ctx.trace else None
    if not t or not ctx.traced_steps:
        return None
    points = ctx.rays * ctx.cfg['num_samples']
    nbytes = ctx.traced_steps * yardstick.k3a_bytes(points, ctx.cfg)
    return 100.0 * nbytes / yardstick.HBM_BYTES_PER_S / t
