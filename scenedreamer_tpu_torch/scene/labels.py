"""Minecraft voxel id -> reduced segmentation label.

Counterpart of `LabelTranslator.mc2reduced` in
`scenedreamer_tpu/scene/labels.py` (reference `mc_utils.py:163-274`),
reading its own copy of `assets/label_luts.npz` into a torch lookup
table. The other translations wait for the training slice.
"""
import functools
import json
import os

import numpy as np
import torch

_ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'assets')

NUM_REDUCED_LABELS = 12


@functools.lru_cache(maxsize=1)
def _luts():
    arrays = np.load(os.path.join(_ASSET_DIR, 'label_luts.npz'))
    with open(os.path.join(_ASSET_DIR, 'label_luts.json')) as f:
        meta = json.load(f)
    return (torch.from_numpy(arrays['mcid2rdid'].astype(np.int64)),
            int(meta['ignore_id']), int(meta['dirt_id']))


def mc2reduced(mc, ign2dirt=False):
    """Gather the reduced label of each minecraft id in `mc` (any
    integer tensor); with `ign2dirt`, the ignore label becomes dirt."""
    lut, ignore_id, dirt_id = _luts()
    red = lut.to(mc.device)[mc.long()]
    if ign2dirt:
        red = torch.where(red == ignore_id,
                          torch.full_like(red, dirt_id), red)
    return red
