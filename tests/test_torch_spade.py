"""The port's frozen SPADE oracle (`models/spade.py`) against the JAX
package's `SPADEWrapper(bn_mode='frozen')` with the same weights, stored
batch-norm statistics, labels and style vector `z`.

Weights are drawn with numpy at unit-variance scale (the xavier(0.02)
init gives images of 1e-4, which would hide a wrong layer) and go to the
port through `spade_state_dict_from_flax`. Float32 images agree to 1e-4
(convolutions summed in another order through ~30 layers); the bf16
oracle, cast as the training CLIs cast it, to 0.06 (bf16 keeps 8 bits and
the two frameworks round at different places). `_nearest` is an index
map and must be bit-equal. The port's state dict carries the reference's
names: the JAX package's `convert_spade` maps it back onto the flax
variables exactly."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scenedreamer_tpu.models import spade as jspade
from scenedreamer_tpu.utils.convert import convert_spade
from scenedreamer_tpu_torch.models import spade as tspade
from scenedreamer_tpu_torch.utils.convert import spade_state_dict_from_flax
from _torch_parity import cap_torch_threads

cap_torch_threads()

KW = dict(num_labels=184, num_filters=4, spade_filters=8, style_dims=16)


@functools.lru_cache(maxsize=None)
def _init_tree(size):
    """The variables' tree and shapes (one flax init per variant; the
    values are redrawn by `_variables`)."""
    label = np.zeros((1, 64, 64, 184), np.float32)
    return jspade.SPADEWrapper(out_size=size, **KW).init(
        {'params': jax.random.PRNGKey(0), 'style': jax.random.PRNGKey(1)},
        {'label': label}, random_style=True)


def _variables(size, res, seed=0):
    """Flax variables with unit-scale weights and non-trivial statistics,
    a one-hot label map and a style vector, all from numpy."""
    model = jspade.SPADEWrapper(out_size=size, **KW)
    rng = np.random.default_rng(seed)
    label = np.eye(184, dtype=np.float32)[rng.integers(0, 184, (1, res, res))]
    z = rng.standard_normal((1, 16)).astype(np.float32)
    init = _init_tree(size)

    def weight(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == 'kernel':
            fan_in = int(np.prod(shape[:-1]))
            return (rng.standard_normal(shape) / np.sqrt(fan_in)) \
                .astype(np.float32)
        if name == 'var':
            return rng.uniform(0.5, 2.0, shape).astype(np.float32)
        if name == 'scale':
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)
    variables = jax.tree_util.tree_map_with_path(weight, dict(init))
    variables['params'] = {
        'spade_generator': variables['params']['spade_generator']}
    return model, variables, label, z


def _port(size, variables, dtype=torch.float32):
    model = tspade.SPADEWrapper(out_size=size, **KW)
    missing = model.load_state_dict(spade_state_dict_from_flax(variables))
    assert not missing.missing_keys and not missing.unexpected_keys
    return model.eval().to(dtype)


@pytest.mark.parametrize('size,res', [(256, 48), (512, 64), (1024, 64)])
def test_spade_image_matches_jax(size, res):
    jmodel, variables, label, z = _variables(size, res)
    want = np.asarray(jmodel.apply(variables, {'label': label, 'z': z})
                      ['fake_images'])
    with torch.no_grad():
        got = _port(size, variables)(
            {'label': torch.from_numpy(label), 'z': torch.from_numpy(z)})
    got = got['fake_images'].numpy()
    assert got.shape == want.shape == (1, res, res, 3)
    assert np.abs(want).max() > 0.05 and np.abs(want).max() <= 1.0
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_spade_bf16_oracle_matches_jax_bf16():
    jmodel, variables, label, z = _variables(256, 48, seed=1)
    cast = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                  variables)
    want = np.asarray(jmodel.apply(
        cast, {'label': jnp.asarray(label, jnp.bfloat16),
               'z': jnp.asarray(z, jnp.bfloat16)})['fake_images']
        .astype(jnp.float32))
    with torch.no_grad():
        got = _port(256, variables, torch.bfloat16)(
            {'label': torch.from_numpy(label), 'z': torch.from_numpy(z)})
    got = got['fake_images']
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.06, rtol=0)


def test_random_style_draws_from_the_generator():
    _, variables, label, _ = _variables(256, 32)
    model = _port(256, variables)
    data = {'label': torch.from_numpy(label)}
    with torch.no_grad():
        a = model(data, generator=torch.Generator().manual_seed(3))
        b = model(data, generator=torch.Generator().manual_seed(3))
        c = model(data, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a['fake_images'], b['fake_images'])
    assert not torch.equal(a['fake_images'], c['fake_images'])
    assert a['mu'] is None and a['logvar'] is None
    # an encoded style needs the style encoder, which the frozen oracle
    # is built without (`test_torch_spade_train.py` holds the encoder)
    with pytest.raises(ValueError, match='style_encoder'):
        model({'label': data['label'], 'images': data['label'][..., :3]},
              random_style=False)


@pytest.mark.parametrize('shape,size', [((5, 7), (3, 4)), ((6, 6), (12, 12)),
                                        ((9, 4), (13, 10)),
                                        ((96, 96), (3, 3))])
def test_nearest_is_bit_equal(shape, size):
    x = np.random.default_rng(0).standard_normal((2,) + shape + (3,)) \
        .astype(np.float32)
    want = np.asarray(jspade._nearest(jnp.asarray(x), size))
    got = tspade._nearest(torch.from_numpy(x).permute(0, 3, 1, 2), size) \
        .permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
    legacy = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), size=size, mode='nearest')
    np.testing.assert_array_equal(got, legacy.permute(0, 2, 3, 1).numpy())


@pytest.mark.parametrize('size,res', [(256, 64), (512, 64)])
def test_state_dict_round_trips_through_convert_spade(size, res):
    _, variables, _, _ = _variables(size, res, seed=2)
    sd = _port(size, variables).state_dict()
    assert 'spade_generator.head_1.conv_block_0.layers.norm.mlps.0.0' \
           '.layers.conv.weight' in sd
    assert 'spade_generator.cbn_up_0a.layers.norm.norm.running_var' in sd
    back = convert_spade(sd, num_filters=KW['num_filters'])
    flat_want = jax.tree_util.tree_leaves_with_path(variables)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_want) == len(flat_got)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[path]), leaf,
                                      err_msg=str(path))


def test_frozen_batch_norm_defaults_to_identity_statistics():
    bn = tspade.FrozenBatchNorm(3)
    x = torch.randn(2, 3, 4, 4)
    torch.testing.assert_close(bn(x), x * (1 + 1e-5) ** -0.5)
    assert not list(bn.parameters())
