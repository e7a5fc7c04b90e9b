"""float32 arithmetic rounded the way the JAX package's compiled code
rounds it.

XLA fuses `a * b + c` into one fused multiply-add inside a compiled
function (the DDA start point, the hash-grid cell position, the
renderer's sample points, `jnp.cross` and the vector norm). Where a
float32 rounding step decides a discrete outcome (which voxel a ray
starts in, which grid cell a point falls in) the port rounds the same
way: the kernels call `__fmaf_rn`, and the plain PyTorch versions use
`fma` below. A float32 product is exact in float64, so
float64(a) * b + c rounded once to float32 is the fused result (a
second rounding could only differ on an exact float32 tie).
"""
import torch


def fma(a, b, c):
    """float32 a * b + c with a single rounding (broadcasting)."""
    return (torch.as_tensor(a).double() * torch.as_tensor(b).double()
            + torch.as_tensor(c).double()).float()


def cross3(a, b):
    """`jnp.cross` of 3-vectors as XLA rounds it:
    out_i = fma(a_j, b_k, -(a_k * b_j))."""
    cols = []
    for j, k in ((1, 2), (2, 0), (0, 1)):
        cols.append(fma(a[..., j], b[..., k], -(a[..., k] * b[..., j])))
    return torch.stack(cols, dim=-1)


def norm3(v, keepdim=False):
    """`jnp.linalg.norm` over a last axis of 3 as XLA rounds it:
    sqrt(fma(z, z, fma(y, y, x * x)))."""
    x, y, z = v.unbind(-1)
    n = torch.sqrt(fma(z, z, fma(y, y, x * x)))
    return n[..., None] if keepdim else n
