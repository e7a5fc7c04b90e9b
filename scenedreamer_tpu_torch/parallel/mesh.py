"""Process groups for multi-GPU training: the ('data', 'rays') mesh.

Counterpart of `scenedreamer_tpu/parallel/mesh.py` (reference
`imaginaire/utils/distributed.py:12-117`, NCCL DDP). One process per
device, `torch.distributed` between them. The world of ranks is laid out
as a data x rays grid: rank r sits at data index r // rays and rays index
r % rays.

  * `data`: batch data parallelism. Each data group trains on its own
    batch; the trainer means gradients, metrics and the discriminator's
    spectral-norm state over every rank before the clip and the skip
    decision (JAX's `pmean` over 'data' inside its shard_map step).
  * `rays`: the image rows. The ranks of one rays group share one batch;
    each renders its band of rows through `render_pixels`, the feature
    map is put together in the group (`RowBand.gather`, with its
    gradient), and the RenderCNN, the losses and D run on the whole image
    on every rank of the group (JAX shards the rows through GSPMD and
    constrains D's inputs to the batch axis).

The gradient of a band arrives once from each of the group's R identical
whole-image losses, so it is R times the rays=1 gradient of those rows;
the gradients of everything after the gather are equal across the group.
A mean over all data x rays ranks is then the data mean of the rays=1
gradient (tested).

The gather uses `all_reduce` alone: its forward sums bands padded with
zeros (exact: every element has one non-zero term), its backward sums
the whole-image gradient and keeps this rank's band. gloo runs
`all_reduce` on CUDA tensors, so two ranks can share one card over gloo,
where NCCL refuses two ranks on one device.
"""
import dataclasses
import os

import torch
import torch.distributed as dist

# batch keys that are per-sample only (batch axis only); every other key
# with an image-row axis at dim 1 is cut on 'rays'
_BATCH_ONLY_KEYS = ('cam_ori', 'height_field', 'semantic_field', 'z')

_RENDEZVOUS = ('MASTER_ADDR', 'MASTER_PORT', 'RANK', 'WORLD_SIZE')


def init_distributed(device=None, backend=None):
    """The env:// rendezvous of torchrun (reference `init_dist`,
    `utils/distributed.py:12-18`): MASTER_ADDR, MASTER_PORT, RANK,
    WORLD_SIZE and LOCAL_RANK. The backend is `backend`, else NCCL for a
    CUDA `device` (the default) and gloo for the CPU; on CUDA the
    process's device is set from LOCAL_RANK. Without the rendezvous
    variables it does nothing. Returns (rank, world size)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if not all(k in os.environ for k in _RENDEZVOUS):
        return 0, 1
    dev = torch.device('cuda' if device is None else device)
    if backend is None:
        backend = 'nccl' if dev.type == 'cuda' else 'gloo'
    kw = {}
    if dev.type == 'cuda':
        local = torch.device('cuda', int(os.environ.get('LOCAL_RANK', 0)))
        torch.cuda.set_device(local)
        if backend == 'nccl':
            kw['device_id'] = local
    dist.init_process_group(backend, init_method='env://', **kw)
    return dist.get_rank(), dist.get_world_size()


def world_size():
    return dist.get_world_size() if dist.is_initialized() else 1


def rank():
    return dist.get_rank() if dist.is_initialized() else 0


def comm_device():
    """Where this process's collectives take their tensors: NCCL takes
    CUDA tensors only, gloo CPU tensors as well."""
    if dist.is_initialized() and dist.get_backend() == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the ('data', 'rays') grid and the groups it
    belongs to: `data_group` holds the ranks at its rays index (one per
    data group), `rays_group` the ranks of its data group. The groups are
    None in one process."""
    data: int
    rays: int
    data_index: int = 0
    rays_index: int = 0
    data_group: object = None
    rays_group: object = None

    @property
    def shape(self):
        return {'data': self.data, 'rays': self.rays}

    @property
    def group_root(self):
        """The global rank of the first rank of this rank's rays group
        (the one that builds the group's batches)."""
        return self.data_index * self.rays

    def row_band(self, height):
        """This rank's band of `height` image rows as a `RowBand`, or None
        when the rows stay whole: rays = 1, or rows that do not divide
        (`band_rows`)."""
        rows = band_rows(height, self.rays, self.rays_index)
        if self.rays == 1 or rows is None:
            return None
        return RowBand(rows, height, self.rays_group)


def band_rows(height, rays, index):
    """The rows of band `index` of `height` image rows cut in `rays`
    bands, or None where the rows do not divide by `rays`: every rank
    then holds them all, as JAX replicates an axis that does not divide.
    The one place that decides the 'rays' cut."""
    if height % rays:
        return None
    n = height // rays
    return slice(index * n, (index + 1) * n)


def mesh_groups(data, rays):
    """The ranks of each group, (data_groups, rays_groups):
    `data_groups[j]` the ranks at rays index j, one per data group;
    `rays_groups[d]` the ranks of data group d. Rank r sits at data
    index r // rays, rays index r % rays."""
    return ([[d * rays + j for d in range(data)] for j in range(rays)],
            [[d * rays + j for j in range(rays)] for d in range(data)])


def make_mesh(data=None, rays=1):
    """The ('data', 'rays') mesh over the world's ranks (JAX
    `make_mesh`). `data` defaults to world // rays; every rank must call
    it (each group is made by all ranks)."""
    n = world_size()
    if n % rays:
        raise ValueError(f'{n} devices not divisible by rays={rays}')
    data = n // rays if data is None else data
    if data * rays != n:
        raise ValueError(f'a {data} x {rays} mesh needs {data * rays} '
                         f'ranks, the world has {n}')
    if not dist.is_initialized():
        return Mesh(1, 1)
    r = rank()
    data_groups, rays_groups = mesh_groups(data, rays)
    mine = {}
    for axis, groups in (('data', data_groups), ('rays', rays_groups)):
        for ranks in groups:
            g = dist.new_group(ranks)
            if r in ranks:
                mine[axis] = g
    return Mesh(data, rays, r // rays, r % rays, mine['data'], mine['rays'])


def batch_spec(key, shape, mesh=None):
    """The axes one batch entry is cut on, as a tuple of 'data' / 'rays'
    / None per dimension (JAX `batch_spec`'s PartitionSpec): the batch
    axis on 'data' where it divides, the image rows of a ray key on
    'rays' where `band_rows` cuts them; the rest is replicated."""
    ndim = len(shape)
    n_data = mesh.data if mesh is not None else 1
    n_rays = mesh.rays if mesh is not None else 1
    axes = [None] * ndim
    if ndim >= 1 and shape[0] % n_data == 0:
        axes[0] = 'data'
    if (ndim >= 2 and key not in _BATCH_ONLY_KEYS
            and band_rows(shape[1], n_rays, 0) is not None):
        axes[1] = 'rays'
    return tuple(axes)


def shard_batch(mesh, batch):
    """This rank's piece of a batch that every rank holds whole: the
    block of `batch_spec` at (data index, rays index), the whole extent
    on each replicated axis (what JAX's `shard_batch` puts on the
    device at that place of the mesh)."""
    out = {}
    for k, v in batch.items():
        axes = batch_spec(k, tuple(v.shape), mesh)
        if axes and axes[0] == 'data':
            n = v.shape[0] // mesh.data
            v = v.narrow(0, mesh.data_index * n, n)
        if len(axes) > 1 and axes[1] == 'rays':
            v = v[:, band_rows(v.shape[1], mesh.rays, mesh.rays_index)]
        out[k] = v
    return out


def replicate(module):
    """Broadcast `module`'s parameters and buffers from rank 0 (JAX
    `replicate`: parameters are the same on every device)."""
    if not dist.is_initialized():
        return module
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, 0)
    return module


def global_batch_from_local(mesh, local_batch):
    """This rank's piece of the global batch, which is its local batch,
    after JAX's check (`global_batch_from_local`, `:122-145`): the global
    batch, the data groups' local batches end to end, must divide the
    'data' axis in multi-process mode, each data group holding its share
    (the mean of the per-rank means is the global mean only then). The
    training CLI checks its first batch so."""
    n = world_size()
    if n > 1:
        sizes = {k: v.shape[0] for k, v in local_batch.items() if v.dim()}
        every = [None] * n
        dist.all_gather_object(every, sizes)
        for k in sizes:
            per = [s[k] for s in every]
            total = sum(per[::mesh.rays])       # one rank per data group
            if total % mesh.data or any(p != total // mesh.data
                                        for p in per):
                raise ValueError(
                    f'global batch dim {total} of {k!r} must divide the '
                    f"'data' axis ({mesh.data}) in multi-process mode, "
                    f'each data group holding its share (local batches '
                    f'{per})')
    return local_batch


def broadcast_batch(mesh, batch, device):
    """The batch of this rank's rays group, built by its first rank
    (`Mesh.group_root`, which passes it) and sent to the others (which
    pass None and receive it on `device`). The identity when rays = 1."""
    if mesh.rays == 1:
        return batch
    meta = [None if batch is None else
            {k: (tuple(v.shape), v.dtype) for k, v in batch.items()}]
    dist.broadcast_object_list(meta, src=mesh.group_root,
                               group=mesh.rays_group, device=comm_device())
    out = {}
    for k, (shape, dtype) in meta[0].items():
        t = batch[k].contiguous() if batch is not None else torch.empty(
            shape, dtype=dtype, device=device)
        dist.broadcast(t, src=mesh.group_root, group=mesh.rays_group)
        out[k] = t
    return out


def check_replicated(*modules):
    """Raise unless every rank holds the same parameters and buffers in
    `modules` (compared through each tensor's float64 sum and sum of
    squares, gathered from every rank)."""
    if world_size() == 1:
        return
    fp = torch.tensor([[float(t.double().sum()), float((t.double() ** 2)
                                                      .sum())]
                       for m in modules for t in m.state_dict().values()
                       if t.is_floating_point()], dtype=torch.float64,
                      device=comm_device())
    every = [torch.empty_like(fp) for _ in range(world_size())]
    dist.all_gather(every, fp)
    if not all(torch.equal(e, every[0]) for e in every):
        raise RuntimeError('the ranks hold different parameters')


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


def all_mean(x, group):
    """The mean of `x` over the ranks of `group`, differentiable: the
    gradient of each rank's `x` is the mean over the group of the
    gradients of the result (the backward of a mean whose terms live on
    every rank). Each rank must hold an equal share of the data the
    mean stands for."""
    return _AllMean.apply(x, group)


class _AllMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.detach().clone()
        dist.all_reduce(out, group=group)
        return out / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad / dist.get_world_size(ctx.group), None


@dataclasses.dataclass(frozen=True)
class RowBand:
    """A band of image rows rendered by this rank of a rays group:
    `rows` of the image's `height`, put together with the group's other
    bands by `gather`."""
    rows: slice
    height: int
    group: object

    def gather(self, x):
        """[B, rows, ...] band -> the whole [B, height, ...] image, with
        the gradient of this rank's band summed over the group."""
        return _GatherRows.apply(x, self)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, band, rb):
        ctx.rb = rb
        full = band.new_zeros((band.shape[0], rb.height) + band.shape[2:])
        full[:, rb.rows] = band
        dist.all_reduce(full, group=rb.group)
        return full

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.rb.group)
        return grad[:, ctx.rb.rows], None
