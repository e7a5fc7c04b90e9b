"""SPADE / GauGAN oracle trainer, the `configs/landscape1m.yaml` loop, in
PyTorch.

Counterpart of `scenedreamer_tpu/train/spade_trainer.py` (reference
`train.py` + `imaginaire/trainers/spade.py` upstream): hinge GAN against
the multi-scale patch discriminator, VGG19 perceptual, feature matching,
the style VAE's KL, an EMA of the generator (`landscape1m.yaml:8-24`).

`train_step` is JAX's step:
  * D update: the generator in training mode without gradients (batch
    statistics, as the reference's no_grad train-mode forward); the new
    running statistics it returns are dropped. D sees the detached fake
    with its spectral-norm vectors as they are and the real images with
    the power iteration advanced (`spade_dis_loss`'s `dis_apply_real`);
  * G update: the generator in training mode, the loss through the
    updated D, whose vectors are read but not advanced; the new running
    statistics are adopted only when the update is taken;
  * each update clips and validates its gradients (`clip_and_validate`)
    and skips a non-finite one, keeping parameters and optimizer state;
  * the EMA of every parameter (the batch norms' weight and bias
    included, not their running statistics): a copy before `ema_start`,
    beta `ema_beta` from then on.
`generate` runs the generator in eval mode (running statistics), on the
EMA parameters when they are kept.

With a `parallel.mesh.Mesh` over several processes (torchrun) the step is
data-parallel: the batch norms mean their statistics over the mesh's
data group (`models/spade.set_sync_group`, forward and backward), the KL
sum is scaled to the whole batch's, and each update means its gradients,
its metrics (and, in the D update, the spectral-norm state) over the
ranks in one all_reduce before the clip and the skip decision. Every rank
then takes the same decision and holds the same state, as JAX's globally
sharded step does. The ranks share the caller's seed and each takes its
rows of the whole batch's style draw.
"""
import numpy as np
import torch

from scenedreamer_tpu_torch.models.spade import (adopt_batch_stats,
                                                 set_sync_group)
from scenedreamer_tpu_torch.train import gan_losses as G
from scenedreamer_tpu_torch.train.optim import ScheduledAdam, make_schedule
from scenedreamer_tpu_torch.train.trainer import (TrainerConfig, _floats,
                                                  clip_and_validate, frozen,
                                                  mean_over_ranks,
                                                  split_generator)


def _adam(params, lr):
    """optax.adam(lr, b1=0, b2=0.999): eps 1e-8, constant rate (the JAX
    trainer's default optimizers)."""
    return ScheduledAdam([(lr, list(params))],
                         make_schedule({'type': 'constant'}), eps=1e-8)


class SpadeTrainer:
    """D and G updates around a `models/spade.SPADEWrapper` built with
    trainable batch norms (`bn_mode='train'`) and a style encoder, and a
    `train/gan_losses.MultiScaleDiscriminator`. Batches are {'images':
    [B, H, W, 3] in [-1, 1], 'label': [B, H, W, num_labels] one-hot} on
    the models' device. The style eps of each update comes from its own
    generator, split from the caller's (JAX's `kd, kg = split(key)`), or
    is given (`style_eps`)."""

    def __init__(self, generator, discriminator, cfg=None, perceptual=None,
                 g_opt=None, d_opt=None, gan_mode='hinge',
                 loss_weights=G.SPADE_LOSS_WEIGHTS, ema_start=1000,
                 mesh=None):
        self.cfg = cfg = cfg if cfg is not None else TrainerConfig()
        self.gen, self.dis = generator.train(), discriminator
        self.perceptual = perceptual
        self.gan_mode = gan_mode
        self.loss_weights = dict(loss_weights)
        self.ema_start = ema_start
        self.g_opt = g_opt if g_opt is not None else _adam(
            generator.parameters(), 1e-4)
        self.d_opt = d_opt if d_opt is not None else _adam(
            discriminator.parameters(), 4e-4)
        self.step = 0
        self.g_ema = {n: p.detach().clone()
                      for n, p in generator.named_parameters()} \
            if cfg.ema_beta > 0 else None
        self.mesh = mesh if mesh is not None and mesh.data_group \
            is not None else None
        if self.mesh is not None and self.mesh.rays != 1:
            raise ValueError('SPADE training is data-parallel only; '
                             f'the mesh is {self.mesh.shape}')
        # one rank's batch statistics are the whole batch's at data 1
        set_sync_group(generator, self.mesh.data_group
                       if self.mesh is not None and self.mesh.data > 1
                       else None)

    # ------------------------------------------------------------------
    def _generate(self, batch, generator, style_eps):
        if style_eps is None and self.mesh is not None:
            # this rank's rows of the whole batch's draw, so that the
            # ranks together draw what one process would
            b = batch['label'].shape[0]
            eps = torch.randn((b * self.mesh.data, self.gen.style_dims),
                              generator=generator,
                              device=batch['label'].device)
            style_eps = eps[self.mesh.data_index * b:
                            (self.mesh.data_index + 1) * b]
        return self.gen(batch, random_style=False, generator=generator,
                        style_eps=style_eps)

    def _dis_update(self, batch, fake):
        self.d_opt.zero_grad()

        def dis_apply(images, label):
            return self.dis(images, label)

        def dis_apply_real(images, label):
            return self.dis(images, label, update_stats=True)

        loss, m = G.spade_dis_loss(dis_apply, fake, batch,
                                   weights=self.loss_weights,
                                   gan_mode=self.gan_mode,
                                   dis_apply_real=dis_apply_real)
        loss.backward()
        mean_over_ranks(self.mesh, self.d_opt.params, m, self.dis.buffers())
        ok, m['dis/grad_norm'] = clip_and_validate(self.d_opt.params,
                                                   self.cfg)
        if ok:
            self.d_opt.step()
        return m

    def _gen_update(self, batch, generator, style_eps):
        self.g_opt.zero_grad()
        out = self._generate(batch, generator, style_eps)
        with frozen(self.dis):
            loss, m = G.spade_gen_loss(
                lambda images, label: self.dis(images, label), out, batch,
                perceptual=self.perceptual, weights=self.loss_weights,
                gan_mode=self.gan_mode,
                batch_shards=1 if self.mesh is None else self.mesh.data)
        loss.backward()
        mean_over_ranks(self.mesh, self.g_opt.params, m)
        ok, m['gen/grad_norm'] = clip_and_validate(self.g_opt.params,
                                                   self.cfg)
        if ok:
            self.g_opt.step()
            adopt_batch_stats(self.gen, out['batch_stats'])
        if self.g_ema is not None:
            # float32 beta and 1 - beta, as JAX computes them
            beta = np.float32(self.cfg.ema_beta if self.step >= self.ema_start
                              else 0.0)
            with torch.no_grad():
                for n, p in self.gen.named_parameters():
                    self.g_ema[n].mul_(float(beta)).add_(
                        p * float(np.float32(1.0) - beta))
        return m

    def train_step(self, batch, generator=None, style_eps=(None, None)):
        """One D update, then one G update (JAX `_train_step`); the style
        eps per update as a (D, G) pair, else drawn. Returns the metrics
        as floats."""
        gd, gg = split_generator(generator)
        with torch.no_grad():
            fake = self._generate(batch, gd, style_eps[0])['fake_images']
        dm = self._dis_update(batch, fake)
        gm = self._gen_update(batch, gg, style_eps[1])
        self.step += 1
        return _floats({**dm, **gm})

    # ------------------------------------------------------------------
    def generate(self, batch, generator=None, style_eps=None, use_ema=True):
        """The generator in eval mode (running statistics), on the EMA
        parameters when they are kept and `use_ema`; a random style
        without 'images' in `batch`, else the encoded one."""
        params = self.g_ema if use_ema and self.g_ema is not None else {}
        self.gen.eval()
        try:
            with torch.no_grad():
                return torch.func.functional_call(
                    self.gen, params, (batch,),
                    {'random_style': 'images' not in batch,
                     'generator': generator, 'style_eps': style_eps},
                    strict=False)
        finally:
            self.gen.train()

    # ------------------------------------------------------------------
    def state_dict(self):
        """G (parameters and running statistics), G's optimizer, D (with
        its spectral-norm vectors), D's optimizer, the EMA and the step
        (JAX's `SpadeTrainState`)."""
        return {'step': self.step,
                'generator': self.gen.state_dict(),
                'discriminator': self.dis.state_dict(),
                'g_opt': self.g_opt.state_dict(),
                'd_opt': self.d_opt.state_dict(),
                'g_ema': self.g_ema}

    def load_state_dict(self, sd):
        self.step = int(sd['step'])
        self.gen.load_state_dict(sd['generator'])
        self.dis.load_state_dict(sd['discriminator'])
        self.g_opt.load_state_dict(sd['g_opt'])
        self.d_opt.load_state_dict(sd['d_opt'])
        if sd['g_ema'] is not None:
            self.g_ema = {k: v.clone() for k, v in sd['g_ema'].items()}
