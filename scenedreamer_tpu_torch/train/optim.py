"""Optimizers and learning-rate schedules, in PyTorch.

Counterpart of `scenedreamer_tpu/train/optim.py` (reference
`imaginaire/utils/trainer.py:239-348`): Adam with the reference's
beta1 = 0, beta2 = 0.999, eps = 1e-7 (`configs/scenedreamer_train.yaml`
:36-41, 62-67), per-submodule learning rates for the generator
(world_encoder 5e-4, the rest 1e-4; the yaml's `hash_table` group is
the port's `hash_encoder`), and the step / constant / linear schedules.
As in optax, the schedule multiplies the step by sched(count), count
being the number of updates this optimizer has applied.

`make_optimizer` is JAX's single-group `make_optimizer`
(`utils/trainer.py:297-348`), the SPADE trainer's: adam, rmsprop, sgd,
fromage and madam, each with optax's maths (`ScheduledRMSprop` puts eps
inside the square root as `optax.scale_by_rms` does, where
`torch.optim.RMSprop` adds it outside; `ScheduledSGD` is `optax.trace`,
torch's momentum without dampening or Nesterov; Fromage and Madam as the
JAX package writes them, without a schedule). Every optimizer here has
the same interface: `params`, `step()`, `zero_grad()`, `count`,
`state_dict()`, `load_state_dict()`.
"""
import numpy as np
import torch

GEN_PARAM_GROUP_LR = {
    'world_encoder': 5e-4,
    'hash_encoder': 1e-4,
    'render_net': 1e-4,
    'sky_net': 1e-4,
    'style_net': 1e-4,
    'style_encoder': 1e-4,
    'denoiser': 1e-4,
}
GEN_BASE_LR = 1e-4
DIS_LR = 4e-4
ADAM_BETAS = (0.0, 0.999)
ADAM_EPS = 1e-7


def make_schedule(policy=None, iters_per_epoch=1000):
    """LR multiplier schedule step -> float (`utils/trainer.py:239-275`).
    policy: e.g. {'type': 'step', 'step_size': 400, 'gamma': 0.1,
    'iteration_mode': False}; epoch-mode sizes count `iters_per_epoch`
    iterations an epoch."""
    if policy is None:
        policy = {'type': 'step', 'step_size': 400, 'gamma': 0.1,
                  'iteration_mode': False}
    ptype = policy.get('type', 'step')
    unit = 1 if policy.get('iteration_mode', False) else iters_per_epoch
    if ptype == 'constant':
        return lambda step: 1.0
    if ptype == 'step':
        size, gamma = policy['step_size'] * unit, policy['gamma']
        return lambda step: gamma ** (step // size)
    if ptype == 'linear':
        start = policy['decay_start'] * unit
        end = policy['decay_end'] * unit
        target = policy['decay_target']

        def sched(step):
            frac = ((step - start) * target + end - step) / (end - start)
            return min(max(frac, target), 1.0)
        return sched
    raise NotImplementedError(f'lr policy {ptype}')


class ScheduledAdam:
    """torch.optim.Adam over named parameter groups, each with its base
    learning rate, times a schedule of the update count."""

    def __init__(self, groups, schedule, eps=ADAM_EPS):
        """groups: [(base_lr, [params])]."""
        self.base_lrs = [lr for lr, _ in groups]
        self.opt = torch.optim.Adam(
            [{'params': ps, 'lr': lr} for lr, ps in groups],
            betas=ADAM_BETAS, eps=eps)
        self.schedule = schedule
        self.count = 0

    @property
    def params(self):
        return [p for g in self.opt.param_groups for p in g['params']]

    def step(self):
        mult = self.schedule(self.count)
        for group, lr in zip(self.opt.param_groups, self.base_lrs):
            group['lr'] = lr * mult
        self.opt.step()
        self.count += 1

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)

    def state_dict(self):
        return {'adam': self.opt.state_dict(), 'count': self.count}

    def load_state_dict(self, sd):
        self.opt.load_state_dict(sd['adam'])
        self.count = int(sd['count'])


def make_generator_optimizer(generator, group_lrs=None, lr_policy=None,
                             iters_per_epoch=1000):
    """Adam with one learning rate per top-level submodule of the
    generator (`gancraft_base.py:388-427`); parameters of other modules
    take `GEN_BASE_LR`."""
    group_lrs = dict(GEN_PARAM_GROUP_LR if group_lrs is None else group_lrs)
    groups = {}
    for name, p in generator.named_parameters():
        top = name.split('.')[0]
        groups.setdefault(top if top in group_lrs else '__base__',
                          []).append(p)
    return ScheduledAdam(
        [(group_lrs.get(k, GEN_BASE_LR), ps) for k, ps in groups.items()],
        make_schedule(lr_policy, iters_per_epoch))


def make_discriminator_optimizer(discriminator, lr=DIS_LR, lr_policy=None,
                                 iters_per_epoch=1000):
    return ScheduledAdam([(lr, list(discriminator.parameters()))],
                         make_schedule(lr_policy, iters_per_epoch))


class _Single:
    """One group of parameters updated by a rule of optax's form: the
    rule's direction times sched(count) times -lr, added to each
    parameter (`optax.apply_updates`). Subclasses give `_init` (the state
    as {name: [tensor per parameter]}) and `_update` (in place, under
    no_grad)."""

    def __init__(self, params, lr, schedule):
        self._params = list(params)
        self.lr, self.schedule = lr, schedule
        self.count = 0
        with torch.no_grad():
            self.state = self._init()

    @property
    def params(self):
        return self._params

    def zero_grad(self):
        for p in self._params:
            p.grad = None

    @torch.no_grad()
    def step(self):
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self._params]
        self._update(grads, self.schedule(self.count))
        self.count += 1

    def _apply(self, p, direction, mult):
        p.add_((direction * mult) * -self.lr)

    def state_dict(self):
        return {'state': {k: [t.clone() for t in v]
                          for k, v in self.state.items()},
                'count': self.count}

    def load_state_dict(self, sd):
        for k, v in sd['state'].items():
            for t, src in zip(self.state[k], v):
                t.copy_(src)
        self.count = int(sd['count'])


class ScheduledRMSprop(_Single):
    """`optax.scale_by_rms(decay=0.9, eps)`: nu = 0.1 g^2 + 0.9 nu from
    nu = 0, direction g * rsqrt(nu + eps)."""

    def __init__(self, params, lr, schedule, decay=0.9, eps=1e-7):
        self.decay, self.eps = decay, eps
        super().__init__(params, lr, schedule)

    def _init(self):
        return {'nu': [torch.zeros_like(p) for p in self._params]}

    def _update(self, grads, mult):
        for p, g, nu in zip(self._params, grads, self.state['nu']):
            nu.copy_((1.0 - self.decay) * g ** 2 + self.decay * nu)
            self._apply(p, g * torch.rsqrt(nu + self.eps), mult)


class ScheduledSGD(_Single):
    """`optax.trace(decay=momentum)`: t = g + momentum * t from t = 0
    (torch's SGD momentum without dampening or Nesterov); momentum 0 is
    plain SGD."""

    def __init__(self, params, lr, schedule, momentum=0.9):
        self.momentum = momentum
        super().__init__(params, lr, schedule)

    def _init(self):
        return {'trace': [torch.zeros_like(p) for p in self._params]
                if self.momentum else []}

    def _update(self, grads, mult):
        if not self.momentum:
            for p, g in zip(self._params, grads):
                self._apply(p, g, mult)
            return
        for p, g, t in zip(self._params, grads, self.state['trace']):
            t.copy_(g + self.momentum * t)
            self._apply(p, t, mult)


class Fromage(_Single):
    """Fromage (arXiv:2002.03432; reference `optimizers/fromage.py`) as
    the JAX package's `scale_by_fromage`: per tensor, g scaled by
    |p| / (|g| + 1e-12) when both norms are positive, then
    p <- (p - lr * g') / sqrt(1 + lr^2). No schedule."""

    def __init__(self, params, lr, eps=1e-12):
        self.eps = eps
        super().__init__(params, lr, lambda count: 1.0)

    def _init(self):
        return {}

    def _update(self, grads, mult):
        shrink = float(np.float32(1.0 / np.sqrt(1.0 + self.lr ** 2)))
        for p, g in zip(self._params, grads):
            gn, pn = torch.linalg.norm(g), torch.linalg.norm(p)
            scaled = torch.where((gn > 0) & (pn > 0),
                                 g * (pn / (gn + self.eps)), g)
            p.add_((p - self.lr * scaled) * shrink - p)


class Madam(_Single):
    """Madam (arXiv:2006.14560; reference `optimizers/madam.py`) as the
    JAX package writes it: v = 0.999 v + 0.001 g^2, g' = nan_to_num(g /
    sqrt(v / (1 - 0.999^step))), p <- clip(p * exp(-lr g' sign(p)),
    +-max) with max = scale * rms(p) fixed at construction. No
    schedule."""

    def __init__(self, params, lr, scale=3.0, g_bound=None):
        self.scale, self.g_bound = scale, g_bound
        super().__init__(params, lr, lambda count: 1.0)

    def _init(self):
        return {'max': [self.scale * torch.sqrt(torch.mean(p * p))
                        for p in self._params],
                'exp_avg_sq': [torch.zeros_like(p) for p in self._params]}

    def _update(self, grads, mult):
        step = torch.tensor(float(self.count + 1), dtype=torch.float32)
        bias_c = 1.0 - torch.tensor(0.999, dtype=torch.float32) ** step
        for p, g, v, pmax in zip(self._params, grads,
                                 self.state['exp_avg_sq'],
                                 self.state['max']):
            v.copy_(0.999 * v + 0.001 * g * g)
            gn = torch.nan_to_num(g / torch.sqrt(v / bias_c.to(v.device)))
            if self.g_bound is not None:
                gn = torch.clamp(gn, -self.g_bound, self.g_bound)
            newp = torch.clamp(p * torch.exp(-self.lr * gn * torch.sign(p)),
                               -pmax, pmax)
            p.add_(newp - p)


OPTIMIZERS = ('adam', 'rmsprop', 'sgd', 'fromage', 'madam')


def make_optimizer(params, opt_type='adam', lr=GEN_BASE_LR, lr_policy=None,
                   iters_per_epoch=1000, momentum=0.9):
    """A single-group optimizer over `params` (JAX `make_optimizer`,
    reference `utils/trainer.py:297-348`); `lr_policy` as in
    `make_schedule` (adam, rmsprop and sgd)."""
    params = list(params)
    if opt_type not in OPTIMIZERS:
        raise NotImplementedError(f'optimizer {opt_type}')
    sched = make_schedule(lr_policy, iters_per_epoch)
    if opt_type == 'adam':
        return ScheduledAdam([(lr, params)], sched)
    if opt_type == 'rmsprop':
        return ScheduledRMSprop(params, lr, sched)
    if opt_type == 'sgd':
        return ScheduledSGD(params, lr, sched, momentum)
    if opt_type == 'fromage':
        return Fromage(params, lr)
    return Madam(params, lr)
