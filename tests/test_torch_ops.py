"""The port's plain ops against the JAX package's on the same numpy
inputs: positional encoding, compositing weights, depth sampling (with
JAX's own random draws fed in), and the reduced-label lookup."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scenedreamer_tpu.ops import compositing as jcomp
from scenedreamer_tpu.ops import pe as jpe
from scenedreamer_tpu.ops import sampling as jsamp
from scenedreamer_tpu.scene.labels import get_label_translator
from scenedreamer_tpu_torch.ops import compositing as tcomp
from scenedreamer_tpu_torch.ops import pe as tpe
from scenedreamer_tpu_torch.ops import sampling as tsamp
from scenedreamer_tpu_torch.scene.labels import mc2reduced
from _torch_parity import cap_torch_threads

cap_torch_threads()


def _intervals(rng, r=300, m=6):
    entry = np.cumsum(rng.uniform(0.0, 3.0, (r, m)), -1) + 5.0
    depth = np.stack([entry, entry + rng.uniform(0.0, 1.5, (r, m))],
                     -1).astype(np.float32)
    cnt = rng.integers(0, m + 1, r)
    mask = np.arange(m)[None] < cnt[:, None]
    return depth, mask


@pytest.mark.parametrize('deterministic,boxes', [(True, False),
                                                 (False, False),
                                                 (False, True)])
def test_sample_depth_matches_jax(deterministic, boxes):
    depth, mask = _intervals(np.random.default_rng(0))
    nsamples = 7 if boxes else 25
    key = jax.random.PRNGKey(3)
    j = jsamp.sample_depth(key, jnp.asarray(depth), jnp.asarray(mask),
                           nsamples, deterministic=deterministic,
                           use_box_boundaries=boxes, sample_depth_clip=3.0)
    # the same U[0,1) draws the JAX op takes from its key
    k_bound, k_samp = jax.random.split(key)
    uniforms = {
        'samples': np.array(jax.random.uniform(
            k_samp, (depth.shape[0], nsamples))),
        'boundary': np.array(jax.random.uniform(k_bound, mask.shape))}
    t = tsamp.sample_depth(torch.from_numpy(depth), torch.from_numpy(mask),
                           nsamples, deterministic=deterministic,
                           use_box_boundaries=boxes, sample_depth_clip=3.0,
                           uniforms=uniforms)
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))


def test_volume_rendering_and_pe_match_jax():
    rng = np.random.default_rng(1)
    sigma = rng.standard_normal((5, 7, 40, 1)).astype(np.float32)
    dists = rng.uniform(0, 0.2, (5, 7, 40, 1)).astype(np.float32)
    j = jcomp.volume_rendering_relu(jnp.asarray(sigma), jnp.asarray(dists))
    t = tcomp.volume_rendering_relu(torch.from_numpy(sigma),
                                    torch.from_numpy(dists))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                               atol=1e-6)
    x = rng.uniform(-1, 1, (9, 3)).astype(np.float32)
    j = jpe.positional_encoding(jnp.asarray(x), 5, True)
    t = tpe.positional_encoding(torch.from_numpy(x), 5, True)
    assert t.shape[-1] == tpe.pe_out_dim(3, 5, True)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6,
                               rtol=0)


def test_mc2reduced_matches_jax():
    ids = np.arange(680, dtype=np.int32).reshape(20, 34)
    trans = get_label_translator()
    for ign2dirt in (False, True):
        j = np.asarray(trans.mc2reduced(jnp.asarray(ids), ign2dirt=ign2dirt))
        t = mc2reduced(torch.from_numpy(ids), ign2dirt=ign2dirt).numpy()
        np.testing.assert_array_equal(t, j)
