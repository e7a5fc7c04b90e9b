"""The reference's data-parallel mean: one flat all_reduce over every
rank of the default process group (the port's `all_mean_`)."""
import torch
import torch.distributed as dist


def all_mean_(tensors):
    """Replace each float tensor of `tensors` by its mean over the
    world's ranks, in one flat `all_reduce` of float32."""
    tensors = list(tensors)
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    off = 0
    with torch.no_grad():
        for t in tensors:
            t.copy_(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()
