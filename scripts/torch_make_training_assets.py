"""A synthetic paired dataset and a PCG terrain cache for a training campaign
(`scenedreamer_tpu_torch/cli/campaign.py:make_training_assets`; the
port's counterpart of `scripts/make_training_assets.py`).

    python scripts/torch_make_training_assets.py --outdir assets \\
        --num-images 64 --image-size 320 --terrain-size 512 --crop 256

The JAX script's flags, plus `--device` (CUDA unless 'cpu' is asked for).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from scenedreamer_tpu_torch.cli.campaign import make_training_assets  # noqa: E402

if __name__ == '__main__':
    make_training_assets()
