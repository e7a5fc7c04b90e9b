"""The window's model operations over what the cards' float32 peak gives
in the window, in %: per step (`yardstick.train_step_flops`) the
generator's field on the rays with a hit, sky, RenderCNN, style and
world encoders forward and backward, the discriminator's and VGG19's
passes, summed over the ranks, over window seconds x ranks x 67
TFLOP/s; the traced steps and their host time left out."""
from portbench import yardstick


def read(ctx):
    if not ctx.flops or ctx.untraced_s <= 0:
        return None
    return 100.0 * ctx.flops / (ctx.untraced_s * ctx.world_size
                                * yardstick.FP32_FLOP_PER_S)
