"""Weights cross between the two packages without loss: flax params ->
the port's state dict -> the JAX package's converter gives back every
generator leaf exactly, the style encoder's included; the
discriminator's and VGG19's flax variables load strictly into the port's
modules with the right layouts (their outputs are held against JAX in
`test_torch_train_modules.py`)."""
import numpy as np
import pytest
import torch

from scenedreamer_tpu.utils.convert import convert_scenedreamer_generator
from scenedreamer_tpu_torch.models.generator import SceneDreamerGenerator
from scenedreamer_tpu_torch.utils.convert import \
    generator_state_dict_from_flax
from _torch_parity import cap_torch_threads, port_config, tiny_models
from test_golden import TINY

cap_torch_threads()


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
    want = dict(_flat(flax_params['params']))
    got = dict(_flat(back['params']))
    assert any(p[0] == 'style_encoder' for p in want)
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
    assert 'style_encoder.layer6.weight' in sd
    # fc_mu reads the last [4, 4, C] map NCHW-flattened, flax NHWC
    fw = np.asarray(p['style_encoder']['fc_mu']['weight'])
    c = fw.shape[1] // 16
    np.testing.assert_array_equal(
        sd['style_encoder.fc_mu.weight'].numpy().reshape(-1, c, 4, 4)
        .transpose(0, 2, 3, 1).reshape(fw.shape), fw)
    dense = generator_state_dict_from_flax(
        {'fc': {'kernel': np.arange(6.0).reshape(2, 3)}})
    np.testing.assert_array_equal(dense['fc.weight'].numpy(),
                                  np.arange(6.0).reshape(2, 3).T)


def test_discriminator_and_vgg_load_strictly():
    import jax
    import jax.numpy as jnp
    from scenedreamer_tpu.models.discriminator import \
        GANcraftDiscriminator as JDis
    from scenedreamer_tpu.train.losses import PerceptualLoss
    from scenedreamer_tpu_torch.models.discriminator import \
        GANcraftDiscriminator
    from scenedreamer_tpu_torch.models.vgg import VGG19Features
    from scenedreamer_tpu_torch.utils.convert import (
        discriminator_state_dict_from_flax, vgg_state_dict_from_flax)
    data = {'fake_masks': jnp.zeros((1, 16, 16, 12))}
    v = JDis(num_labels=12, num_filters=4).init(
        jax.random.PRNGKey(0), data, {'fake_images': jnp.zeros((1, 16, 16, 3))})
    sd = discriminator_state_dict_from_flax(v, v)
    GANcraftDiscriminator(num_labels=12, num_filters=4).load_state_dict(
        sd, strict=True)
    k = np.asarray(v['params']['fpse']['enc2']['Conv_0']['kernel'])
    np.testing.assert_array_equal(sd['fpse.enc2.weight'].numpy(),
                                  k.transpose(3, 2, 0, 1))
    u = v['spectral_stats']['fpse']['enc2']['SpectralNorm_0']
    np.testing.assert_array_equal(sd['fpse.enc2.weight_u'].numpy(),
                                  np.asarray(u['Conv_0/kernel/u']))
    assert 'fpse.output.weight_u' not in sd
    perc = PerceptualLoss(layers=('relu_2_1',), weights=(1.0,))
    VGG19Features(('relu_2_1',)).load_state_dict(
        vgg_state_dict_from_flax(perc.params), strict=True)


def test_paired_variant_table_converts_like_xor():
    """`hash_variant` changes how rows are addressed, not the table: the
    same leaf, the same shape, copied as it is."""
    import dataclasses
    cfg = dataclasses.replace(TINY, hash_variant='paired')
    params = tiny_models(key_seed=2, batch_hw=12, cfg=cfg)[2]
    sd = generator_state_dict_from_flax(params)
    model = SceneDreamerGenerator(port_config(cfg))
    model.load_state_dict(sd, strict=True)
    assert model.cfg.hash_spec.hash_variant == 'paired'
    table = np.asarray(params['params']['hash_table'])
    assert tuple(sd['hash_encoder.embeddings'].shape) == table.shape \
        == (model.cfg.hash_spec.table_size, cfg.hash_level_dim)
    np.testing.assert_array_equal(sd['hash_encoder.embeddings'].numpy(),
                                  table)
    back = convert_scenedreamer_generator(
        {k: v.numpy() for k, v in model.state_dict().items()})
    np.testing.assert_array_equal(np.asarray(back['params']['hash_table']),
                                  table)


def test_nonuniform_table_round_trips(flax_params):
    """A spec that is not foldable has levels of different sizes (here
    248, 1024, 1024, 1024 rows); the flat [table_size, C] table crosses
    both ways as it is, with the model built from the JAX config."""
    import dataclasses
    from scenedreamer_tpu.models.generator import GeneratorConfig as JCfg
    from scenedreamer_tpu.ops.hashgrid import foldable as jfoldable
    from scenedreamer_tpu_torch.ops.hashgrid import general_levels
    cfg = dataclasses.replace(TINY, hash_base_resolution=2,
                              hash_desired_resolution=16)
    assert isinstance(cfg, JCfg) and not jfoldable(cfg.hash_spec)
    model = SceneDreamerGenerator(port_config(cfg))
    spec = model.cfg.hash_spec
    assert [lv.size for lv in general_levels(spec)] == [248, 1024, 1024,
                                                        1024]
    assert spec.table_size == cfg.hash_spec.table_size == 3320
    table = np.random.default_rng(4).standard_normal(
        (spec.table_size, cfg.hash_level_dim)).astype(np.float32)
    params = {'params': {**flax_params['params'], 'hash_table': table}}
    sd = generator_state_dict_from_flax(params)
    model.load_state_dict(sd, strict=True)
    np.testing.assert_array_equal(
        model.hash_encoder.embeddings.detach().numpy(), table)
    back = convert_scenedreamer_generator(
        {k: v.numpy() for k, v in model.state_dict().items()})
    np.testing.assert_array_equal(np.asarray(back['params']['hash_table']),
                                  table)
