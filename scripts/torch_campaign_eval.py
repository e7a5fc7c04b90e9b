"""FID / KID of every checkpoint of a training run against a pseudo-GT set
(`scenedreamer_tpu_torch/cli/campaign.py:campaign_eval`; the port's
counterpart of `scripts/campaign_eval.py`).

    python scripts/torch_campaign_eval.py --run-dir logs/<run> \\
        --real-dir pgt --terrain-cache assets/terrain_cache --outdir eval \\
        --num-images 64

The JAX script's flags, plus `--device` (CUDA unless 'cpu' is asked for).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from scenedreamer_tpu_torch.cli.campaign import campaign_eval  # noqa: E402

if __name__ == '__main__':
    campaign_eval()
