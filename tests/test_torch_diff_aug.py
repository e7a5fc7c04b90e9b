"""The port's DiffAugment (`scenedreamer_tpu_torch/utils/diff_aug.py`)
against the JAX package's, on the CPU, with JAX's own draws fed to the
port's ops (`_torch_parity.jax_diff_aug_draws`, JAX's key split order).

Each op, and the three in a row, on a [2, 22, 18, 3] batch (H != W, odd
cutout span): the augmented image and the gradient to the input of a
seeded cotangent. Translation and cutout move or zero values and are held
equal; color is float32 arithmetic with two means (reduction order), held
to 1e-6 absolute on values of magnitude ~1."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenedreamer_tpu.utils.diff_aug import apply_diff_aug as j_apply
from scenedreamer_tpu_torch.utils import diff_aug
from _torch_parity import cap_torch_threads, jax_diff_aug_draws

cap_torch_threads()

SHAPE = (2, 22, 18, 3)
ATOL = {'translation': 0.0, 'cutout': 0.0}


@pytest.mark.parametrize('policy', ['color', 'translation', 'cutout',
                                    'color,translation,cutout'])
def test_op_and_gradient_match_jax(policy):
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, SHAPE).astype(np.float32)
    cot = rng.normal(size=SHAPE).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want, vjp = jax.vjp(lambda v: j_apply(v, key, policy), jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = diff_aug.apply_diff_aug(xt, policy,
                                  jax_diff_aug_draws(key, policy, SHAPE))
    got.backward(torch.from_numpy(cot))
    atol = ATOL.get(policy, 1e-6)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g), rtol=0,
                               atol=atol)
    if policy != 'color':
        assert (got.detach() == 0).any()      # something was cut or filled


def test_draws_cover_jax_ranges():
    """The port's own draws: one entry per op in policy order, in the
    ranges JAX draws from, and every value reached."""
    g = torch.Generator().manual_seed(0)
    b, h, w = 512, 22, 18
    color, trans, cut = diff_aug.draw('color,translation,cutout',
                                      (b, h, w, 3), g)
    for u in color:
        assert u.shape == (b,) and 0 <= float(u.min()) \
            and float(u.max()) < 1
    sh, sw = int(h * 0.125 + 0.5), int(w * 0.125 + 0.5)
    assert set(trans[0].tolist()) == set(range(-sh, sh + 1))
    assert set(trans[1].tolist()) == set(range(-sw, sw + 1))
    ch, cw = int(h * 0.5 + 0.5), int(w * 0.5 + 0.5)
    assert set(cut[0].tolist()) == set(range(h + 1 - ch % 2))
    assert set(cut[1].tolist()) == set(range(w + 1 - cw % 2))
    assert diff_aug.draw('', (b, h, w, 3), g) == []
    with pytest.raises(ValueError, match='unknown DiffAugment'):
        diff_aug.parse_policy('color,flip')
