"""Label translation across minecraft-voxel / coco-stuff / reduced label
sets.

Counterpart of `scenedreamer_tpu/scene/labels.py` (reference
`MCLabelTranslator`, `mc_utils.py:163-274`, and `ReducedLabelMapper`,
`mc_lbl_reduction.py:9-79`), reading its own copy of
`assets/label_luts.npz` / `.json` into torch lookup tables. Every
translation is a gather on the device of its input.
"""
import functools
import json
import os

import numpy as np
import torch

from scenedreamer_tpu_torch.device import tensor_cache

_ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'assets')

NUM_MC_LABELS = 680
NUM_COCO_LABELS = 184  # coco-stuff labels used by the SPADE oracle
NUM_REDUCED_LABELS = 12


@functools.lru_cache(maxsize=1)
def _load():
    arrays = dict(np.load(os.path.join(_ASSET_DIR, 'label_luts.npz')))
    with open(os.path.join(_ASSET_DIR, 'label_luts.json')) as f:
        meta = json.load(f)
    return arrays, meta


class LabelTranslator:
    """Immutable LUT bundle; the translate methods take integer tensors
    on any device and return int64 tensors there."""

    def __init__(self):
        arrays, meta = _load()
        self.mc2coco_lut = torch.from_numpy(arrays['mc2coco'].astype(np.int64))
        self.mcid2rdid_lut = torch.from_numpy(
            arrays['mcid2rdid'].astype(np.int64))
        # index 182 (clamped "unknown") maps to ignore, as in the reference
        # (`mc_utils.py:225`: ggid2rdid + [0]).
        self.ggid2rdid_lut = torch.from_numpy(np.concatenate(
            [arrays['ggid2rdid'], [0]]).astype(np.int64))
        self.mc2color_lut = np.asarray(arrays['mc2color'], np.uint32)
        self.reduced_lbls = meta['reduced_lbls']
        self.gg_labels = meta['gg_labels']
        self.ignore_id = int(meta['ignore_id'])
        self.dirt_id = int(meta['dirt_id'])
        self.water_id = int(meta['water_id'])
        self.num_reduced_lbls = len(self.reduced_lbls)
        self._on = {}

    def _lut(self, name, device):
        """The named LUT on `device` (moved there once, outside a trace:
        while `torch.export` traces, the copy would be a fake tensor)."""
        if torch.compiler.is_compiling():
            return getattr(self, name).to(device)
        key = (name, str(device))
        if key not in self._on:
            self._on[key] = getattr(self, name).to(device)
        return self._on[key]

    def mc2coco(self, mc):
        return self._lut('mc2coco_lut', mc.device)[mc.long()]

    def mc2reduced(self, mc, ign2dirt=False):
        red = self._lut('mcid2rdid_lut', mc.device)[mc.long()]
        if ign2dirt:
            red = torch.where(red == self.ignore_id,
                              torch.full_like(red, self.dirt_id), red)
        return red

    def coco2reduced(self, coco):
        lut = self._lut('ggid2rdid_lut', coco.device)
        return lut[coco.long().clamp(0, lut.shape[0] - 1)]

    def gglbl2ggid(self, gglbl):
        return self.gg_labels.index(gglbl)

    def get_num_reduced_lbls(self):
        return self.num_reduced_lbls

    def mc_color(self, img):
        """Minecraft default colors for a [H, W] int segmentation map
        (host side, numpy)."""
        rgb_packed = self.mc2color_lut[np.asarray(img)]
        dt = np.dtype(('u4', [('bytes', 'u1', 4)]))
        return rgb_packed.view(dt)['bytes'][..., :3]


@tensor_cache(maxsize=1)
def get_label_translator():
    """The process's `LabelTranslator` (a new one while `torch.export`
    traces: its tables would be fake tensors)."""
    return LabelTranslator()


def mc2reduced(mc, ign2dirt=False):
    """Gather the reduced label of each minecraft id in `mc` (any
    integer tensor); with `ign2dirt`, the ignore label becomes dirt."""
    return get_label_translator().mc2reduced(mc, ign2dirt)
