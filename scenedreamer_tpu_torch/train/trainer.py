"""GAN training engine: discriminator and generator updates, in PyTorch.

Counterpart of `scenedreamer_tpu/train/trainer.py` without its mesh and
shard_map paths (reference `imaginaire/trainers/base.py:676-816`,
`imaginaire/trainers/gancraft.py:158-251`):
  * D update: G forward without gradients, N+1 GAN loss on (fake, real)
    and (fake, pseudo-real), weights gan = pseudo_gan = 0.5; the
    spectral-norm vectors advance in this update only;
  * G update: GAN + pseudo-GAN (the same fake-vs-real objective twice),
    optional feature matching against pseudo-real D features, the style
    VAE's Gaussian KL, VGG19 perceptual and L2 against the pseudo ground
    truth;
  * `train_step` = D update, then G update with its own render;
    `train_step_shared` renders once and keeps the graph: D updates on
    the detached fake, the G loss goes through the updated D, and the G
    backward runs through the kept graph (the JAX package's
    single-forward step; the same math as `dis_step` then `gen_step`
    with the same draws);
  * global-norm clipping, the skip of a non-finite or too large
    (`skip_grad_norm`) gradient, which keeps parameters and optimizer
    state, and EMA averaging of G;
  * checkpoints written with `torch.save`, found through the same
    `latest_checkpoint.txt` pointer.

Batches are dicts of NHWC tensors on the models' device. Each step
returns its metrics as Python floats (one device sync per update, for
the skip decision and the metrics).
"""
import contextlib
import dataclasses
import math
import os

import torch

from scenedreamer_tpu_torch.train import losses as L
from scenedreamer_tpu_torch.train import optim


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
    # DiffAugment policy of the D inputs; only '' (off, the shipped
    # default) is ported
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
                 d_opt=None):
        self.cfg = cfg = cfg if cfg is not None else TrainerConfig()
        if cfg.aug_policy:
            raise NotImplementedError(
                'DiffAugment (aug_policy) is not ported; only the '
                "shipped default '' is")
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

    # ------------------------------------------------------------------
    def _render(self, batch, generator, style_eps, compact_k=None):
        return self.gen(batch, self.voxel_dims, random_style=False,
                        generator=generator, style_eps=style_eps,
                        compact_k=compact_k)

    def _dis_loss(self, batch, fake):
        """D loss (`gancraft.py:206-251`) on a detached fake."""
        w = self.cfg.loss_weights
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

    def _dis_update(self, batch, fake):
        self.d_opt.zero_grad()
        loss, m = self._dis_loss(batch, fake.detach())
        loss.backward()
        ok, m['dis/grad_norm'] = clip_and_validate(self.d_opt.params,
                                                   self.cfg)
        if ok:
            self.d_opt.step()
        return _floats(m)

    def _gen_loss(self, g_out, batch):
        """G loss (`gancraft.py:158-204`) from the generator's outputs,
        through the current D (its parameters frozen, its spectral-norm
        vectors read but not advanced)."""
        w = self.cfg.loss_weights
        total, m = 0.0, {}
        fake = g_out['fake_images']
        if 'gan' in w or 'pseudo_gan' in w:
            fm = self.cfg.use_feature_matching
            with frozen(self.dis):
                d_out = self.dis(batch, g_out, incl_real=False,
                                 incl_pseudo_real=fm, update_stats=False)
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
    def dis_step(self, batch, generator=None, style_eps=None,
                 compact_k=None):
        """D update on a fresh render (`gancraft.py:206-251`)."""
        with torch.no_grad():
            fake = self._render(batch, generator, style_eps,
                                compact_k)['fake_images']
        return self._dis_update(batch, fake)

    def gen_step(self, batch, generator=None, style_eps=None,
                 compact_k=None):
        """G update on a fresh render (`gancraft.py:158-204`)."""
        self.g_opt.zero_grad()
        g_out = self._render(batch, generator, style_eps, compact_k)
        return self._gen_update(*self._gen_loss(g_out, batch))

    def train_step(self, batch, generator=None, style_eps=(None, None),
                   compact_k=None):
        """One iteration with two renders: `dis_step`, then `gen_step`
        (style draws given per phase as a (D, G) pair)."""
        dm = self.dis_step(batch, generator, style_eps[0], compact_k)
        gm = self.gen_step(batch, generator, style_eps[1], compact_k)
        return {**dm, **gm}

    def train_step_shared(self, batch, generator=None, style_eps=None,
                          compact_k=None):
        """One iteration with ONE render: keep its graph, update D on the
        detached fake, take the G loss through the updated D and run the
        G backward through the kept graph."""
        self.g_opt.zero_grad()
        g_out = self._render(batch, generator, style_eps, compact_k)
        dm = self._dis_update(batch, g_out['fake_images'])
        gm = self._gen_update(*self._gen_loss(g_out, batch))
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


# ---------------------------------------------------------------------------
# Checkpoints (`trainers/base.py:236-325,943-982`)
# ---------------------------------------------------------------------------

def save_checkpoint(ckpt_dir, trainer, step=None):
    """Write `step_<8 digits>.pt` and point `latest_checkpoint.txt` at it;
    returns the path."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    step = trainer.step if step is None else int(step)
    path = os.path.join(ckpt_dir, f'step_{step:08d}.pt')
    torch.save(trainer.state_dict(), path)
    with open(os.path.join(ckpt_dir, 'latest_checkpoint.txt'), 'w') as f:
        f.write(os.path.basename(path) + '\n')
    return path


def latest_checkpoint(ckpt_dir):
    pointer = os.path.join(ckpt_dir, 'latest_checkpoint.txt')
    if not os.path.exists(pointer):
        return None
    with open(pointer) as f:
        path = os.path.join(ckpt_dir, f.read().strip())
    return path if os.path.exists(path) else None


def load_checkpoint(ckpt_dir, trainer):
    """Restore the latest checkpoint into `trainer` (onto its models'
    device); returns its path, or None when there is none."""
    path = latest_checkpoint(ckpt_dir)
    if path is None:
        return None
    device = next(trainer.gen.parameters()).device
    trainer.load_state_dict(torch.load(path, map_location=device,
                                       weights_only=True))
    return path
