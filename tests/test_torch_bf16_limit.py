"""The bf16 frame distance at the full flagship width, on the CPU: the
basis of the card's bf16 limits (`chip_smoke.BF16_LIMIT_*`).

The flagship generator (`GeneratorConfig()`: hash 16 x 2^19 x 8, MLP 256,
CNN 256, feature 64; 6 samples, M=4 to keep the CPU's time) with the
port's seeded init carried to flax by the JAX package's own converter
(`convert_scenedreamer_generator`; a flax init of this width costs ~15
s of compile), and the JAX package's renderer in float32 and in bf16
on 40x64 frames of two poses (the tour pose and the low camera pitched
up of `test_golden.py`): JAX's own bf16-to-float32 distance. The port,
on the same weights and frames, in float32 and bf16: its own distance,
and its bf16 frame's distance from JAX's bf16 frame.

Measured on the CPU (max / mean over the two frames): JAX's own
1.84e-4 / 3.40e-5; the port's own 1.84e-4 / 3.41e-5 (1.00x / 1.00x);
the port's bf16 from JAX's bf16 9.2e-5 / 8.2e-6; the float32 frames
4.6e-8 apart. Held: the port's own distance within 1.25x JAX's (max and
mean; the convs accumulate in another order, so the two bf16 frames are
not equal), its bf16 frame within JAX's own distance of JAX's bf16
frame. `chip_smoke.BF16_JAX_MAX` / `_MEAN` are JAX's own numbers here."""
import dataclasses

import numpy as np
import torch

import jax.numpy as jnp

from scenedreamer_tpu.data.synthetic import make_world
from scenedreamer_tpu.models.generator import GeneratorConfig
from scenedreamer_tpu.models.generator import SceneDreamerGenerator as JGen
from scenedreamer_tpu.render.pipeline import TiledRenderer as JRenderer
from scenedreamer_tpu.scene.labels import get_label_translator
from scenedreamer_tpu.utils.convert import convert_scenedreamer_generator
from scenedreamer_tpu_torch.models.generator import SceneDreamerGenerator
from scenedreamer_tpu_torch.render.pipeline import TiledRenderer
from _torch_parity import cap_torch_threads, port_config
from test_golden import KW, _poses

cap_torch_threads()

FLAGSHIP = GeneratorConfig(num_samples=6, num_blocks_early_stop=4)
FRAME_KW = dict(KW, resolution_hw=(40, 64))
OWN = 1.25          # the port's bf16-to-float32 distance / JAX's, at most


def test_flagship_bf16_frame_distance():
    world = make_world(size=64, seed=7, n_voronoi=20, boundary_detect=4)
    get_label_translator()              # built once, outside the trace
    sd = SceneDreamerGenerator(port_config(FLAGSHIP), seed=3).state_dict()
    params = convert_scenedreamer_generator(
        {k: v.numpy() for k, v in sd.items()})
    style = np.random.default_rng(5).standard_normal(
        (1, FLAGSHIP.style_dims)).astype(np.float32)
    poses = [p for _, p in sorted(_poses(world).items())]
    pkw = {k: v for k, v in FRAME_KW.items() if k != 'fov'}
    frames = {}
    for name, jdt, tdt in (('f32', jnp.float32, torch.float32),
                           ('bf16', jnp.bfloat16, torch.bfloat16)):
        jr = JRenderer(JGen(cfg=dataclasses.replace(FLAGSHIP, dtype=jdt)),
                       params, world, tile_size=16, **FRAME_KW)
        jz = jr.style_z(style)
        model = SceneDreamerGenerator(dataclasses.replace(
            port_config(FLAGSHIP), dtype=tdt))
        model.load_state_dict(sd)
        tr = TiledRenderer(model.eval(), world, device='cpu', **pkw)
        tz = tr.style_z(style)
        frames[name] = (np.stack([np.asarray(jr.frame(p, jz))
                                  for p in poses]),
                        np.stack([tr.frame(p, tz) for p in poses]))

    def dist(a, b):
        d = np.abs(a - b)
        return float(d.max()), float(d.mean())

    (j32, t32), (j16, t16) = frames['f32'], frames['bf16']
    jax_own, port_own = dist(j16, j32), dist(t16, t32)
    to_jax = dist(t16, j16)
    print(f'[bf16 flagship] JAX bf16 to float32 max/mean {jax_own}; port '
          f'{port_own}; port bf16 to JAX bf16 {to_jax}; port float32 to '
          f'JAX float32 {dist(t32, j32)}')
    assert dist(t32, j32)[0] <= 1e-3
    assert 0 < jax_own[0] < 1e-3
    for p, j in zip(port_own, jax_own):
        assert p <= OWN * j, (port_own, jax_own)
    for p, j in zip(to_jax, jax_own):
        assert p <= j, (to_jax, jax_own)
