"""Weights cross between the two packages without loss: flax params ->
the port's state dict -> the JAX package's converter gives back every
leaf exactly (the style encoder, not in the port yet, is skipped)."""
import numpy as np
import pytest
import torch

from scenedreamer_tpu.utils.convert import convert_scenedreamer_generator
from scenedreamer_tpu_torch.models.generator import SceneDreamerGenerator
from scenedreamer_tpu_torch.utils.convert import \
    generator_state_dict_from_flax
from _torch_parity import port_config, tiny_models
from test_golden import TINY


@pytest.fixture(scope='module')
def flax_params():
    return tiny_models(key_seed=1, batch_hw=12)[2]


def _flat(tree, path=()):
    for k, v in tree.items():
        if hasattr(v, 'items'):
            yield from _flat(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def test_round_trip_every_leaf(flax_params):
    sd = generator_state_dict_from_flax(flax_params)
    model = SceneDreamerGenerator(port_config(TINY))
    # strict: the converted names cover every port parameter, no more
    model.load_state_dict(sd, strict=True)
    back = convert_scenedreamer_generator(
        {k: v.numpy() for k, v in model.state_dict().items()})
    want = {p: v for p, v in _flat(flax_params['params'])
            if p[0] != 'style_encoder'}
    got = dict(_flat(back['params']))
    assert set(got) == set(want)
    for p, v in want.items():
        assert got[p].shape == v.shape, p
        np.testing.assert_array_equal(got[p], v, err_msg=str(p))


def test_layouts(flax_params):
    sd = generator_state_dict_from_flax(flax_params)
    p = flax_params['params']
    k = p['denoiser']['conv2a']['kernel']                  # HWIO
    assert tuple(sd['denoiser.conv2a.weight'].shape) == (
        k.shape[3], k.shape[2], k.shape[0], k.shape[1])
    assert torch.equal(sd['hash_encoder.embeddings'],
                       torch.from_numpy(np.array(p['hash_table'])))
    assert 'world_encoder.conv_blocks.0.layers.2.weight' in sd
    assert 'style_net.fc_layers.4.weight' in sd
    assert not any(n.startswith('style_encoder') for n in sd)
    dense = generator_state_dict_from_flax(
        {'fc': {'kernel': np.arange(6.0).reshape(2, 3)}})
    np.testing.assert_array_equal(dense['fc.weight'].numpy(),
                                  np.arange(6.0).reshape(2, 3).T)
