"""SceneDreamer in PyTorch, with hand-written CUDA kernels for Hopper.

Counterpart of the JAX package `scenedreamer_tpu`, module for module
(`scene/`, `ops/`, `models/`, `render/`, `cli/`, `utils/`, `native/`).
The serving path runs here: seed -> terrain -> voxel world -> camera ->
ray-voxel DDA (CUDA kernel, `csrc/dda.cu`) -> depth sampling ->
scene-folded hash-grid encode (CUDA kernels, `csrc/hashgrid_fwd.cu`) ->
RenderMLP / sky / compositing -> RenderCNN.

Public functions keep the JAX package's layouts (NHWC images, flat
`[R, M]` ray arrays). Entry points run on CUDA unless the caller passes
`device='cpu'` (see `device.py`); on CPU tensors every kernel wrapper
runs its plain PyTorch version instead.
"""
