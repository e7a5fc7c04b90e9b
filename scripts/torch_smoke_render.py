"""One PCG scene rendered along a short trajectory by a seeded generator,
end to end (`scenedreamer_tpu_torch/cli/campaign.py:smoke_render`; the
port's counterpart of `scripts/smoke_render.py`).

    python scripts/torch_smoke_render.py --scene-size 256 \\
        --resolution 96 128 --frames 2 [--device cpu]

The JAX script's flags, plus `--device` (CUDA unless 'cpu' is asked for).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from scenedreamer_tpu_torch.cli.campaign import smoke_render  # noqa: E402

if __name__ == '__main__':
    smoke_render()
