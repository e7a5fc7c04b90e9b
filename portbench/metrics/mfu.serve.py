"""The window's model operations over what the card's float32 peak
gives in the window, in %: every frame's field on its rays with a hit,
sky on every ray and RenderCNN on every pixel (`yardstick.py`), over
window seconds x 67 TFLOP/s; the traced part's frames and host time
(profiler start, stop and drain) left out."""
from portbench import yardstick


def read(ctx):
    if not ctx.untraced_hits or ctx.untraced_s <= 0:
        return None
    return 100.0 * ctx.untraced_flops() / (ctx.untraced_s
                                           * yardstick.FP32_FLOP_PER_S)
