"""SceneDreamer in PyTorch, with hand-written CUDA kernels for Hopper.

Counterpart of the JAX package `scenedreamer_tpu`, module for module
(`scene/`, `ops/`, `models/`, `render/`, `cli/`, `utils/`, `native/`,
`data/`, `train/`). The serving path runs here: seed -> terrain -> voxel
world -> camera -> ray-voxel DDA (CUDA kernel, `csrc/dda.cu`) -> depth
sampling -> scene-folded hash-grid encode (CUDA kernels,
`csrc/hashgrid_fwd.cu`) -> RenderMLP / sky / compositing -> RenderCNN.
So does the GAN training step (`train/trainer.py`): the same render,
differentiable, with the hash encode's backward as CUDA kernels
(`csrc/hashgrid_bwd.cu`), the FPSE discriminator, the VGG19 perceptual
loss and Adam.

Public functions keep the JAX package's layouts (NHWC images, flat
`[R, M]` ray arrays). Entry points run on CUDA unless the caller passes
`device='cpu'` (see `device.py`); on CPU tensors every kernel wrapper
runs its plain PyTorch version instead.
"""
