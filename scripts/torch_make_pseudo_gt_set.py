"""The SPADE oracle's pseudo-ground-truth images on the training camera
distribution, the real set of a campaign's FID / KID
(`scenedreamer_tpu_torch/cli/campaign.py:make_pseudo_gt_set`; the port's
counterpart of `scripts/make_pseudo_gt_set.py`).

    python scripts/torch_make_pseudo_gt_set.py --spade-checkpoint oracle.pt \\
        --terrain-cache assets/terrain_cache --outdir pgt --num-images 128

The JAX script's flags, plus `--device` (CUDA unless 'cpu' is asked for).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from scenedreamer_tpu_torch.cli.campaign import make_pseudo_gt_set  # noqa: E402

if __name__ == '__main__':
    make_pseudo_gt_set()
