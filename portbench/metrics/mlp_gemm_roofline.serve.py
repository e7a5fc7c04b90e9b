"""The field and sky MLPs' share of the float32 roofline, in %: their
operations on the traced frames (rays with a hit x samples x the
RenderMLP's per point, plus every ray x the SKYMLP's; `yardstick.py`)
over 67 TFLOP/s (the bound: operations), divided by the device time of
the GEMM kernels in the trace (`Trace.gemm_s`: named like a GEMM and not
a convolution's)."""
from portbench import yardstick


def read(ctx):
    t = ctx.trace.gemm_s() if ctx.trace else None
    if not t or not ctx.traced_hits:
        return None
    return 100.0 * ctx.traced_flops('mlp') / yardstick.FP32_FLOP_PER_S / t
