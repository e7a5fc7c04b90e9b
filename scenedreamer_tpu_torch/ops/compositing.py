"""Volume rendering weights (counterpart of
`scenedreamer_tpu/ops/compositing.py`; reference `mc_utils.py:75-79,154-161`):

    free_energy = relu(sigma) * dists
    w_i = (1 - exp(-fe_i)) * exp(-sum_{j<i} fe_j)
"""
import torch
import torch.nn.functional as F


def cumsum_exclusive(x, dim):
    """Cumulative sum along `dim`, shifted right by one (0 first)."""
    cs = torch.cumsum(x, dim=dim)
    return torch.cat([torch.zeros_like(cs.narrow(dim, 0, 1)),
                      cs.narrow(dim, 0, x.shape[dim] - 1)], dim=dim)


def volume_rendering_relu(sigma, dists, dim=-2):
    """Per-sample compositing weights; sigma/dists broadcast-compatible."""
    free_energy = (F.relu(sigma) * dists).float()
    return (1.0 - torch.exp(-free_energy)) * torch.exp(
        -cumsum_exclusive(free_energy, dim))
