"""Rays with a hit per served frame, the mean over the window's frames
(the program's `TiledRenderer.last_stats['hit_rays']`, which the check
holds to the reference's count on the sampled frames)."""


def read(ctx):
    return sum(ctx.hits) / len(ctx.hits) if ctx.hits else None
