"""A training checkpoint's generator crops on the training camera
distribution, the fake set of a campaign's FID / KID
(`scenedreamer_tpu_torch/cli/campaign.py:render_fake_set`; the port's
counterpart of `scripts/render_fake_set.py`).

    python scripts/torch_render_fake_set.py \\
        --checkpoint logs/<run>/checkpoints \\
        --terrain-cache assets/terrain_cache --outdir fake --num-images 64

The JAX script's flags, plus `--device` (CUDA unless 'cpu' is asked for).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from scenedreamer_tpu_torch.cli.campaign import render_fake_set  # noqa: E402

if __name__ == '__main__':
    render_fake_set()
