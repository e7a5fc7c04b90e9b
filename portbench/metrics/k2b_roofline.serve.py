"""K2b's (`encode_kernel`) share of its roofline, in %: the bytes of the
traced frames' field points (rays with a hit x samples; 3 float32 read
and L*C float32 written per point; the bound: bytes) over 3.35 TB/s,
divided by the kernel's device time in the trace."""
from portbench import yardstick


def read(ctx):
    t = ctx.trace.kernel_s(r'\bencode_kernel\b') if ctx.trace else None
    if not t or not ctx.traced_hits:
        return None
    nbytes = yardstick.k2b_bytes(ctx.traced_points(), ctx.cfg)
    return 100.0 * nbytes / yardstick.HBM_BYTES_PER_S / t
