"""The port's standard GAN losses and multi-scale patch discriminator
(`train/gan_losses.py`) against the JAX package's on the CPU, with the
same numpy inputs and weights.

Tolerances: the losses 1e-6 relative (one reduction of float32 numbers);
the discriminator's logits and features 1e-5 (float32 convs summed in
another order through 5 layers), its advanced power-iteration vectors
and sigma 1e-6; the SPADE losses through the discriminator 1e-5
relative."""
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scenedreamer_tpu.train import gan_losses as JG
from scenedreamer_tpu_torch.train import gan_losses as TG
from scenedreamer_tpu_torch.utils.convert import \
    multiscale_discriminator_state_dict_from_flax
from _torch_parity import cap_torch_threads
from test_torch_spade_train import _flax_multiscale, _redraw

cap_torch_threads()

RTOL = 1e-6


def _logits(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, 6, 6, 1)).astype(np.float32),
            rng.standard_normal((2, 3, 3, 1)).astype(np.float32)]


def _cases():
    for mode in TG.GAN_MODES:
        for t_real, dis_update in ((True, True), (False, True),
                                   (True, False)):
            tops = [(1.0, False)] if dis_update else \
                [(1.0, False), (0.3, False), (0.3, True)]
            for topk, sep in tops:
                yield mode, t_real, dis_update, topk, sep


@pytest.mark.parametrize('mode,t_real,dis_update,topk,sep', list(_cases()))
def test_gan_loss_matches_jax(mode, t_real, dis_update, topk, sep):
    """Every mode, both targets of the D side and the G side with top-k
    over the whole batch or per sample, on a list of two scales and on
    one tensor."""
    logits = _logits(zlib.crc32(repr((mode, t_real, dis_update, topk,
                                      sep)).encode()))
    for x in (logits, logits[0]):
        want = JG.gan_loss(jax.tree_util.tree_map(jnp.asarray, x), t_real,
                           mode, dis_update, topk, sep)
        got = TG.gan_loss([torch.from_numpy(v) for v in x]
                          if isinstance(x, list) else torch.from_numpy(x),
                          t_real, mode, dis_update, topk, sep)
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL,
                                   atol=1e-7)


def test_weighted_mse_and_info_nce_match_jax():
    rng = np.random.default_rng(3)
    x, y, w = (rng.standard_normal((2, 5, 5, 3)).astype(np.float32)
               for _ in range(3))
    np.testing.assert_allclose(
        float(TG.weighted_mse_loss(*map(torch.from_numpy, (x, y, w)))),
        float(JG.weighted_mse_loss(x, y, w)), rtol=RTOL)
    a, b = (rng.standard_normal((6, 16)).astype(np.float32)
            for _ in range(2))
    np.testing.assert_allclose(
        float(TG.info_nce_loss(torch.from_numpy(a), torch.from_numpy(b))),
        float(JG.info_nce_loss(a, b)), rtol=RTOL)


@pytest.fixture(scope='module')
def dis_pair():
    """The landscape1m discriminator's layout at 8 filters (2 scales x 5
    layers, kernel 4, cap 32) on a 128 crop with 6 labels: port weights
    redrawn with numpy, carried to flax."""
    rng = np.random.default_rng(0)
    kw = dict(num_discriminators=2, num_filters=8, max_num_filters=32,
              num_layers=5)
    port = _redraw(TG.MultiScaleDiscriminator(6, **kw), rng)
    params, stats = _flax_multiscale(port.state_dict())
    images = rng.uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32)
    label = np.eye(6, dtype=np.float32)[rng.integers(0, 6, (2, 128, 128))]
    return JG.MultiScaleDiscriminator(**kw), params, stats, port, images, \
        label


@pytest.mark.parametrize('update_stats', [False, True])
def test_multiscale_discriminator_matches_jax(dis_pair, update_stats):
    """Logits and every layer's features of both scales (the pyramid
    halves the images with the antialiased bilinear resize and the labels
    with the nearest one); with `update_stats` the advanced
    spectral-norm vectors and sigma too."""
    jdis, params, stats, port, images, label = dis_pair
    variables = {'params': params, 'spectral_stats': stats}
    if update_stats:
        (out, feat), mut = jdis.apply(variables, images, label,
                                      update_stats=True,
                                      mutable=['spectral_stats'])
    else:
        out, feat = jdis.apply(variables, images, label)
    port = TG.MultiScaleDiscriminator(6, **{
        'num_discriminators': 2, 'num_filters': 8, 'max_num_filters': 32,
        'num_layers': 5})
    port.load_state_dict(multiscale_discriminator_state_dict_from_flax(
        params, stats))
    with torch.no_grad():
        got_out, got_feat = port(torch.from_numpy(images),
                                 torch.from_numpy(label), update_stats)
    assert len(got_out) == len(out) == 2
    for g, w in zip(got_out, out):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)
    for gs, ws in zip(got_feat, feat):
        assert len(gs) == len(ws) == 5
        for g, w in zip(gs, ws):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                       rtol=0)
    if update_stats:
        want = multiscale_discriminator_state_dict_from_flax(
            params, mut['spectral_stats'])
        for k, v in port.state_dict().items():
            if 'weight_u' in k or 'weight_sigma' in k:
                np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                           atol=1e-6, rtol=0, err_msg=k)
                assert not torch.equal(v, torch.from_numpy(
                    np.asarray(_stat(stats, k))))


def _stat(stats, key):
    d, name, leaf = key.split('.')
    return stats[d][name]['SpectralNorm_0'][
        'Conv_0/kernel/' + ('u' if leaf == 'weight_u' else 'sigma')]


def test_spade_losses_match_jax(dis_pair):
    """`spade_dis_loss` with the stats-advancing real forward and
    `spade_gen_loss` (GAN, feature matching, KL) through the same D;
    `batch_shards` scales only the KL sum."""
    jdis, params, stats, port, images, label = dis_pair
    rng = np.random.default_rng(5)
    fake = rng.uniform(-1, 1, images.shape).astype(np.float32)
    mu, logvar = (rng.standard_normal((2, 8)).astype(np.float32)
                  for _ in range(2))
    variables = {'params': params, 'spectral_stats': stats}
    batch = {'images': images, 'label': label}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    weights = {'gan': 1.0, 'feature_matching': 10.0, 'kl': 0.05}

    def japply(x, lbl):
        return jdis.apply(variables, x, lbl)

    def japply_real(x, lbl):
        (o, f), _ = jdis.apply(variables, x, lbl, update_stats=True,
                               mutable=['spectral_stats'])
        return o, f
    jd, jdm = JG.spade_dis_loss(japply, fake, batch, weights,
                                dis_apply_real=japply_real)
    jg, jgm = JG.spade_gen_loss(japply, {'fake_images': fake, 'mu': mu,
                                         'logvar': logvar}, batch,
                                weights=weights)
    port.load_state_dict(multiscale_discriminator_state_dict_from_flax(
        params, stats))
    td, tdm = TG.spade_dis_loss(
        lambda x, lbl: port(x, lbl), torch.from_numpy(fake), tbatch,
        weights, dis_apply_real=lambda x, lbl: port(x, lbl, True))
    port.load_state_dict(multiscale_discriminator_state_dict_from_flax(
        params, stats))
    g_out = {'fake_images': torch.from_numpy(fake),
             'mu': torch.from_numpy(mu), 'logvar': torch.from_numpy(logvar)}
    tg, tgm = TG.spade_gen_loss(lambda x, lbl: port(x, lbl), g_out, tbatch,
                                weights=weights)
    for got, want in ((tdm, jdm), (tgm, jgm)):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
    _, sharded = TG.spade_gen_loss(lambda x, lbl: port(x, lbl), g_out,
                                   tbatch, weights=weights, batch_shards=2)
    np.testing.assert_allclose(float(sharded['gen/kl']),
                               2 * float(tgm['gen/kl']), rtol=1e-6)
    assert float(sharded['gen/gan']) == float(tgm['gen/gan'])
