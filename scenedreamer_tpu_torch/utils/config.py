"""YAML configuration system.

Counterpart of `scenedreamer_tpu/utils/config.py` (reference
`imaginaire/config.py:19-238`: AttrDict with recursive update and
trainer/opt defaults): a small attribute-dict, the same injected
defaults, the same key layout, so one yaml drives both packages.
"""
import os

import yaml


class AttrDict(dict):
    """Dict with attribute access; nests recursively."""

    def __init__(self, d=None):
        super().__init__()
        if d:
            for k, v in d.items():
                self[k] = self._wrap(v)

    @classmethod
    def _wrap(cls, v):
        if isinstance(v, dict) and not isinstance(v, AttrDict):
            return cls(v)
        if isinstance(v, (list, tuple)):
            return type(v)(cls._wrap(x) for x in v)
        return v

    def __setattr__(self, k, v):
        self[k] = self._wrap(v)

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def setdefault_attr(self, k, v):
        if k not in self:
            self[k] = self._wrap(v)
        return self[k]

    def to_dict(self):
        out = {}
        for k, v in self.items():
            if isinstance(v, AttrDict):
                v = v.to_dict()
            elif isinstance(v, (list, tuple)):
                v = [x.to_dict() if isinstance(x, AttrDict) else x for x in v]
            out[k] = v
        return out


def recursive_update(d, u):
    """Deep-merge mapping `u` into AttrDict `d` (reference config.py:226)."""
    for k, v in u.items():
        if isinstance(v, dict):
            node = d.get(k)
            if not isinstance(node, AttrDict):
                node = AttrDict()
                d[k] = node
            recursive_update(node, v)
        else:
            d[k] = AttrDict._wrap(v)
    return d


_TRAINER_DEFAULTS = {
    'image_save_iter': 5000,
    'snapshot_save_epoch': 5,
    'snapshot_save_iter': 10000,
    'max_epoch': 400,
    'max_iter': 1000000,
    'logging_iter': 10,
    'speed_benchmark': False,
}


def default_config():
    cfg = AttrDict()
    for k, v in _TRAINER_DEFAULTS.items():
        cfg[k] = v
    cfg.trainer = AttrDict({
        'model_average_config': {'enabled': False, 'beta': 0.9999,
                                 'start_iteration': 0},
        'loss_weight': {},
        'init': {'type': 'xavier', 'gain': 0.02},
        'grad_clip': {'enabled': False, 'max_norm': 1.0},
        'image_to_tensorboard': False,
    })
    cfg.gen_opt = AttrDict({'type': 'adam', 'lr': 1e-4, 'eps': 1e-7,
                            'adam_beta1': 0.0, 'adam_beta2': 0.999,
                            'lr_policy': {'iteration_mode': False,
                                          'type': 'step', 'step_size': 400,
                                          'gamma': 0.1}})
    cfg.dis_opt = AttrDict({'type': 'adam', 'lr': 4e-4, 'eps': 1e-7,
                            'adam_beta1': 0.0, 'adam_beta2': 0.999,
                            'lr_policy': {'iteration_mode': False,
                                          'type': 'step', 'step_size': 400,
                                          'gamma': 0.1}})
    cfg.data = AttrDict({'num_workers': 4})
    return cfg


class Config(AttrDict):
    """Load a YAML config on top of the defaults.

    Mirrors the surface of the reference `Config(path)` so configs written
    for it (e.g. configs/scenedreamer_train.yaml key layout) carry over.
    """

    def __init__(self, filename=None, overrides=None):
        super().__init__(default_config())
        self.source_filename = filename
        if filename is not None:
            with open(filename) as f:
                loaded = yaml.safe_load(f) or {}
            recursive_update(self, loaded)
        if overrides:
            recursive_update(self, overrides)
        name = 'config'
        if filename:
            name = os.path.splitext(os.path.basename(filename))[0]
        self.setdefault_attr('name', name)
