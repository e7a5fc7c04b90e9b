"""GAN training engine: discriminator and generator updates, in PyTorch.

Counterpart of `scenedreamer_tpu/train/trainer.py` (reference
`imaginaire/trainers/base.py:676-816`,
`imaginaire/trainers/gancraft.py:158-251`):
  * D update: G forward without gradients, N+1 GAN loss on (fake, real)
    and (fake, pseudo-real), weights gan = pseudo_gan = 0.5; the
    spectral-norm vectors advance in this update only;
  * G update: GAN + pseudo-GAN (the same fake-vs-real objective twice),
    optional feature matching against pseudo-real D features, the style
    VAE's Gaussian KL, VGG19 perceptual and L2 against the pseudo ground
    truth;
  * `train_step_shared` renders once and keeps the graph: D updates on
    the detached fake, the G loss goes through the updated D, and the G
    backward runs through the kept graph (the JAX package's
    single-forward step);
  * DiffAugment (`aug_policy`) on D's image inputs in both updates,
    drawn after the update's render from the same generator; the label
    masks pass through;
  * global-norm clipping, the skip of a non-finite or too large
    (`skip_grad_norm`) gradient, which keeps parameters and optimizer
    state, and EMA averaging of G;
  * `state_dict` / `load_state_dict`: the whole state of a trainer;
  * with a `parallel.mesh.Mesh` over several processes, the counterpart
    of JAX's shard_map data-parallel step and GSPMD row sharding: each
    update means its gradients and its metrics (the D update also the
    spectral-norm state) over every rank in one flat all_reduce, after
    the backward and before the clip and the skip decision, so every
    rank takes the same decision; each rank renders its band of rows
    when the mesh has a rays axis (`Mesh.row_band`, see
    `parallel/mesh.py`). Each rank's draws are its own generator's
    (JAX folds the data index into the key); the ranks of a rays group
    must share one batch and one seed.

Batches are dicts of NHWC tensors on the models' device. Each step
returns its metrics as Python floats (one device sync per update, for
the skip decision and the metrics). The models carry their compute
dtype: with bf16 models (AMP, JAX `cli/train.py:48-56`) the parameters,
the optimizer state, the logits and the losses stay float32, and no
loss is scaled (bf16 has float32's exponent range; the skip of a
non-finite gradient stands in for a scaler's retry).
"""
import contextlib
import dataclasses
import math
import os

import torch

from portbench.reference.sd.parallel.mesh import all_mean_
from portbench.reference.sd.train import losses as L
from portbench.reference.sd.train import optim
from portbench.reference.sd.utils import diff_aug


@dataclasses.dataclass
class TrainerConfig:
    loss_weights: dict = dataclasses.field(
        default_factory=lambda: dict(L.DEFAULT_LOSS_WEIGHTS))
    use_feature_matching: bool = False
    grad_clip_norm: float = 0.0
    # skip (not clip) an update whose global gradient norm exceeds this
    # (the reference's `gen_opt.skip_grad`); 0 disables
    skip_grad_norm: float = 0.0
    ema_beta: float = 0.0
    # DiffAugment policy of the D inputs: a comma-joined subset of
    # 'color', 'translation', 'cutout' ('' = off, the shipped default)
    aug_policy: str = ''


def clip_and_validate(params, cfg):
    """Global-norm clip and skip decision on the gradients of `params`
    (`trainers/base.py:702-733`): ok when the norm is finite and, with
    `skip_grad_norm`, no larger than it; a skipped update keeps the
    parameters and the optimizer state. Missing gradients count as zeros
    and are filled in (Adam then advances their state as optax does).
    Returns (ok, grad norm before clipping)."""
    grads = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    gnorm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    if cfg.grad_clip_norm > 0:
        scale = torch.clamp(cfg.grad_clip_norm / (gnorm + 1e-6), max=1.0)
        torch._foreach_mul_(grads, scale)
    gnorm = float(gnorm)
    ok = math.isfinite(gnorm) and (cfg.skip_grad_norm <= 0
                                   or gnorm <= cfg.skip_grad_norm)
    return ok, gnorm


@contextlib.contextmanager
def frozen(module):
    """Parameters of `module` need no gradient inside the block."""
    flags = [(p, p.requires_grad) for p in module.parameters()]
    for p, _ in flags:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)


def mean_over_ranks(mesh, params, metrics, buffers=()):
    """Mean the gradients of `params`, the `metrics` and `buffers` over
    every rank of `mesh` (JAX's `pmean` over 'data'; under rays the ranks
    of a group agree on all but the bands' gradients, see
    `parallel/mesh.py`), in one all_reduce; nothing without a mesh.
    Missing gradients are zeros."""
    if mesh is None:
        return
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    names = list(metrics)
    vals = [torch.as_tensor(metrics[n], dtype=torch.float32,
                            device=params[0].device).detach().clone()
            for n in names]
    all_mean_([p.grad for p in params] + vals + list(buffers))
    metrics.update(zip(names, vals))


def _floats(metrics):
    return {k: float(v.detach()) if torch.is_tensor(v) else float(v)
            for k, v in metrics.items()}


class GANTrainer:
    """D and G updates around a `SceneDreamerGenerator` and a
    `GANcraftDiscriminator` (or modules with their calling conventions).

    The render's draws come from `generator` (a `torch.Generator` on the
    models' device); `style_eps` gives the reparameterisation eps
    instead. `compact_k` runs every render of a step with the generator's
    exact sky-ray compaction (`render_pixels(compact_k=...)`); the
    losses are the same, the gradients equal up to the order of the
    matmuls' sums.
    """

    def __init__(self, generator, discriminator, voxel_dims,
                 cfg=None, perceptual=None, iters_per_epoch=1000,
                 d_opt=None, mesh=None):
        self.cfg = cfg = cfg if cfg is not None else TrainerConfig()
        diff_aug.parse_policy(cfg.aug_policy)
        self.gen, self.dis = generator, discriminator
        # None: set per world by the caller before the first step
        self.voxel_dims = None if voxel_dims is None \
            else tuple(int(d) for d in voxel_dims)
        self.perceptual = perceptual
        self.g_opt = optim.make_generator_optimizer(
            generator, iters_per_epoch=iters_per_epoch)
        self.d_opt = d_opt if d_opt is not None else \
            optim.make_discriminator_optimizer(
                discriminator, iters_per_epoch=iters_per_epoch)
        self.step = 0
        self.g_ema = {n: p.detach().clone()
                      for n, p in generator.named_parameters()} \
            if cfg.ema_beta > 0 else None
        # a `parallel.mesh.Mesh` with process groups: the data-parallel
        # (and row-parallel) step; None or one process: the plain step
        self.mesh = mesh if mesh is not None and mesh.data_group \
            is not None else None

    # ------------------------------------------------------------------
    def _render(self, batch, generator, style_eps, compact_k=None):
        band = None if self.mesh is None else \
            self.mesh.row_band(batch['voxel_id'].shape[1])
        return self.gen(batch, self.voxel_dims, random_style=False,
                        generator=generator, style_eps=style_eps,
                        compact_k=compact_k, band=band)

    def _aug_draws(self, update, name, x, generator):
        """The DiffAugment draws of D input `name` ('images',
        'pseudo_real_img' or 'fake_images') in `update` ('dis' or 'gen'),
        from `generator`. A test replaces this to feed another
        implementation's draws (JAX: `fold_in(key, 101)` for the D update,
        102 for the G update, split 3 ways in that order of names)."""
        return diff_aug.draw(self.cfg.aug_policy, x.shape, generator,
                             x.device)

    def _augment(self, update, batch, fake, names, generator):
        """DiffAugment (`cfg.aug_policy`) on the D inputs `names` of
        `batch` and on `fake`, each with its own draws (JAX
        `trainer.py:166-183`); the label masks pass through."""
        policy = self.cfg.aug_policy
        if not policy:
            return batch, fake
        batch = dict(batch)
        for name in names:
            batch[name] = diff_aug.apply_diff_aug(
                batch[name], policy,
                self._aug_draws(update, name, batch[name], generator))
        fake = diff_aug.apply_diff_aug(
            fake, policy,
            self._aug_draws(update, 'fake_images', fake, generator))
        return batch, fake

    def _dis_loss(self, batch, fake, generator=None):
        """D loss (`gancraft.py:206-251`) on a detached fake."""
        w = self.cfg.loss_weights
        names = [n for n, k in (('images', 'gan'),
                                ('pseudo_real_img', 'pseudo_gan')) if k in w]
        batch, fake = self._augment('dis', batch, fake, names, generator)
        d_out = self.dis(batch, {'fake_images': fake},
                         incl_real='gan' in w,
                         incl_pseudo_real='pseudo_gan' in w,
                         update_stats=True)
        total, m = 0.0, {}
        if 'gan' in w:
            fake_l = L.gan_loss(d_out['fake_outputs'], False, True)
            real_l = L.gan_loss(d_out['real_outputs'], True, True)
            m['dis/gan_fake'], m['dis/gan_real'] = fake_l, real_l
            total = total + w['gan'] * (fake_l + real_l)
        if 'pseudo_gan' in w:
            fake_l = L.gan_loss(d_out['fake_outputs'], False, True)
            preal_l = L.gan_loss(d_out['pseudo_real_outputs'], True, True)
            m['dis/pgan_fake'], m['dis/pgan_real'] = fake_l, preal_l
            total = total + w['pseudo_gan'] * (fake_l + preal_l)
        m['dis/total'] = total
        return total, m

    def _dis_update(self, batch, fake, generator=None):
        self.d_opt.zero_grad()
        loss, m = self._dis_loss(batch, fake.detach(), generator)
        loss.backward()
        mean_over_ranks(self.mesh, self.d_opt.params, m,
                        self.dis.buffers())
        ok, m['dis/grad_norm'] = clip_and_validate(self.d_opt.params,
                                                   self.cfg)
        if ok:
            self.d_opt.step()
        return _floats(m)

    def _gen_loss(self, g_out, batch, generator=None):
        """G loss (`gancraft.py:158-204`) from the generator's outputs,
        through the current D (its parameters frozen, its spectral-norm
        vectors read but not advanced); D sees the augmented fake, the
        other terms the fake itself."""
        w = self.cfg.loss_weights
        total, m = 0.0, {}
        fake = g_out['fake_images']
        if 'gan' in w or 'pseudo_gan' in w:
            fm = self.cfg.use_feature_matching
            d_batch, d_fake = self._augment(
                'gen', batch, fake, ['pseudo_real_img'] if fm else [],
                generator)
            with frozen(self.dis):
                d_out = self.dis(d_batch, {'fake_images': d_fake},
                                 incl_real=False, incl_pseudo_real=fm,
                                 update_stats=False)
            gl = L.gan_loss(d_out['fake_outputs'], True, dis_update=False)
            if 'gan' in w:
                m['gen/gan'] = gl
                total = total + w['gan'] * gl
            if 'pseudo_gan' in w:
                m['gen/pgan'] = gl
                total = total + w['pseudo_gan'] * gl
            if fm:
                m['gen/feature_matching'] = L.feature_matching_loss(
                    d_out['fake_features'], d_out['pseudo_real_features'])
                total = total + w.get('feature_matching', 10.0) \
                    * m['gen/feature_matching']
        if 'kl' in w and g_out['mu'] is not None:
            m['gen/kl'] = L.gaussian_kl_loss(g_out['mu'], g_out['logvar'])
            total = total + w['kl'] * m['gen/kl']
        if 'perceptual' in w and self.perceptual is not None:
            m['gen/perceptual'] = self.perceptual(fake,
                                                  batch['pseudo_real_img'])
            total = total + w['perceptual'] * m['gen/perceptual']
        if 'l2' in w:
            m['gen/l2'] = L.l2_loss(fake, batch['pseudo_real_img'])
            total = total + w['l2'] * m['gen/l2']
        if 'l1' in w:
            m['gen/l1'] = L.l1_loss(fake, batch['pseudo_real_img'])
            total = total + w['l1'] * m['gen/l1']
        m['gen/total'] = total
        return total, m

    def _gen_update(self, loss, m):
        loss.backward()
        mean_over_ranks(self.mesh, self.g_opt.params, m)
        ok, m['gen/grad_norm'] = clip_and_validate(self.g_opt.params,
                                                   self.cfg)
        if ok:
            self.g_opt.step()
        if self.g_ema is not None:
            b = self.cfg.ema_beta
            with torch.no_grad():
                for n, p in self.gen.named_parameters():
                    self.g_ema[n].mul_(b).add_(p, alpha=1.0 - b)
        self.step += 1
        return _floats(m)

    # ------------------------------------------------------------------
    def train_step_shared(self, batch, generator=None, style_eps=None,
                          compact_k=None):
        """One iteration with ONE render: keep its graph, update D on the
        detached fake, take the G loss through the updated D and run the
        G backward through the kept graph."""
        self.g_opt.zero_grad()
        g_out = self._render(batch, generator, style_eps, compact_k)
        dm = self._dis_update(batch, g_out['fake_images'], generator)
        gm = self._gen_update(*self._gen_loss(g_out, batch, generator))
        return {**dm, **gm}

    # ------------------------------------------------------------------
    def state_dict(self):
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
