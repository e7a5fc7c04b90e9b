"""Shared set-up for the port's tests: `cap_torch_threads`, which every
`tests/test_torch_*.py` calls first, and, for the tests that hold the
PyTorch port against the JAX package, the TINY generator of
`test_golden.py` initialised by flax, and the same weights loaded into
the port through its converter. JAX is imported only by the latter, so
the card's tests (`test_torch_cuda.py`, run where JAX is absent) can
import this module."""
import dataclasses

import numpy as np
import torch

from scenedreamer_tpu_torch.models.generator import (GeneratorConfig,
                                                     SceneDreamerGenerator)

TORCH_THREADS = 2


def cap_torch_threads(n=TORCH_THREADS):
    """Caps PyTorch's intra-op CPU threads in this test process. The
    tier-1 run puts 6 pytest workers on the machine's cores, each with a
    PyTorch and an XLA thread pool as wide as the machine, so the pools
    oversubscribe the cores; the port's tests run small tensors, where
    more threads buy little."""
    torch.set_num_threads(n)


def port_config(jcfg):
    """The port's GeneratorConfig with the JAX config's values."""
    return GeneratorConfig(**{f.name: getattr(jcfg, f.name)
                              for f in dataclasses.fields(GeneratorConfig)
                              if f.name != 'dtype'})


def tiny_models(key_seed=0, batch_hw=20, cfg=None, serving=False):
    """(world, flax model, flax params as numpy, port model, batch of
    numpy arrays) as `test_golden._build` makes them, for the JAX
    generator config `cfg` (TINY by default). `serving`: the init jitted
    (a quarter of the eager init's time, leaves within 6e-8 of it) and
    without the style encoder, which serving does not run: the port
    keeps its own init there."""
    import jax
    from scenedreamer_tpu.data.synthetic import make_batch, make_world
    from scenedreamer_tpu.models.generator import \
        SceneDreamerGenerator as JGen
    from scenedreamer_tpu.scene.labels import get_label_translator
    from scenedreamer_tpu_torch.utils.convert import \
        generator_state_dict_from_flax
    from test_golden import TINY
    cfg = TINY if cfg is None else cfg
    world = make_world(size=64, seed=7, n_voronoi=20, boundary_detect=4)
    jmodel = JGen(cfg=cfg)
    batch = make_batch(world, batch_size=1, height=batch_hw, width=batch_hw,
                       max_samples=4, pad=cfg.pad, seed=0,
                       include_gan_data=False)
    key = jax.random.PRNGKey(key_seed)
    if serving:
        # built outside the trace: the translator is cached, and one made
        # while tracing would keep the trace's arrays
        get_label_translator()
        params = jax.jit(lambda k, b: jmodel.init(
            {'params': k}, b, world.dims, k, random_style=True))(key, batch)
    else:
        params = jmodel.init({'params': key}, batch, world.dims, key,
                             random_style=True)
        # the style encoder's leaves come from an init that
        # style-encodes; every other leaf stays the golden tests' own
        gan_batch = make_batch(world, batch_size=1, height=batch_hw,
                               width=batch_hw, max_samples=4, pad=cfg.pad,
                               seed=0, include_gan_data=True)
        style = jmodel.init({'params': key}, gan_batch, world.dims, key,
                            random_style=False)['params']['style_encoder']
        params = {'params': {**params['params'], 'style_encoder': style}}
    params = jax.tree_util.tree_map(np.asarray, params)
    tmodel = SceneDreamerGenerator(port_config(cfg))
    missing, unexpected = tmodel.load_state_dict(
        generator_state_dict_from_flax(params), strict=not serving)
    assert not unexpected
    assert all(k.startswith('style_encoder.') for k in missing)
    tmodel.eval()
    batch = {k: np.asarray(v) for k, v in batch.items()}
    return world, jmodel, params, tmodel, batch


def jax_diff_aug_draws(key, policy, shape):
    """The random values JAX's `apply_diff_aug(x, key, policy)` draws for
    an image batch of `shape` [B, H, W, C], as torch tensors in the form
    `scenedreamer_tpu_torch.utils.diff_aug.draw` returns them: one key
    split off per policy entry, then 3 uniforms for 'color' and 2
    randints for 'translation' and 'cutout' (`utils/diff_aug.py`)."""
    import jax
    b, h, w, _ = shape
    out = []
    for p in (q.strip() for q in policy.split(',')):
        key, sub = jax.random.split(key)
        if p == 'color':
            vals = [jax.random.uniform(k, (b, 1, 1, 1))
                    for k in jax.random.split(sub, 3)]
        elif p == 'translation':
            k1, k2 = jax.random.split(sub)
            sh, sw = int(h * 0.125 + 0.5), int(w * 0.125 + 0.5)
            vals = [jax.random.randint(k1, (b,), -sh, sh + 1),
                    jax.random.randint(k2, (b,), -sw, sw + 1)]
        else:
            k1, k2 = jax.random.split(sub)
            ch, cw = int(h * 0.5 + 0.5), int(w * 0.5 + 0.5)
            vals = [jax.random.randint(k1, (b, 1, 1), 0, h + (1 - ch % 2)),
                    jax.random.randint(k2, (b, 1, 1), 0, w + (1 - cw % 2))]
        out.append(tuple(torch.from_numpy(np.array(v).reshape(b))
                         for v in vals))
    return out
