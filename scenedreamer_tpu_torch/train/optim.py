"""Optimizers and learning-rate schedules, in PyTorch.

Counterpart of `scenedreamer_tpu/train/optim.py` (reference
`imaginaire/utils/trainer.py:239-348`): Adam with the reference's
beta1 = 0, beta2 = 0.999, eps = 1e-7 (`configs/scenedreamer_train.yaml`
:36-41, 62-67), per-submodule learning rates for the generator
(world_encoder 5e-4, the rest 1e-4; the yaml's `hash_table` group is
the port's `hash_encoder`), and the step / constant / linear schedules.
As in optax, the schedule multiplies the step by sched(count), count
being the number of updates this optimizer has applied. Fromage, Madam,
RMSprop and SGD are not ported.
"""
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

    def __init__(self, groups, schedule):
        """groups: [(base_lr, [params])]."""
        self.base_lrs = [lr for lr, _ in groups]
        self.opt = torch.optim.Adam(
            [{'params': ps, 'lr': lr} for lr, ps in groups],
            betas=ADAM_BETAS, eps=ADAM_EPS)
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
