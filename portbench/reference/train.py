"""The plain reference of the training step: the frozen copy's classes
(`reference/sd`), which the training driver builds, fills from the seed
and drives exactly as it drives the program's (`drivers/train_steps.py`):
the pool from the same camera proposals and accept decisions (the plain
DDA), the generator's forward with the plain hash encode and its
autograd backward (`encode_bwd_plain`, `bake_plain`, `bake_dw_plain`),
the discriminator, the VGG19 and GAN losses, and `torch.optim.Adam`;
on several ranks the copy's own all_reduce of the gradients.
"""
from types import SimpleNamespace


def reference_modules():
    from portbench.reference.sd.models.discriminator import \
        GANcraftDiscriminator
    from portbench.reference.sd.models.generator import (
        GeneratorConfig, SceneDreamerGenerator)
    from portbench.reference.sd.train.losses import PerceptualLoss
    from portbench.reference.sd.train.sampling import (
        CameraBatchSampler, CameraSamplerConfig, TrainingBatchBuilder)
    from portbench.reference.sd.train.trainer import (GANTrainer,
                                                      TrainerConfig)
    return SimpleNamespace(**locals())
