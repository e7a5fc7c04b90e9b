"""Synthetic world, training batch and paired-dataset builders for tests,
smoke runs and dry runs.

Counterpart of `scenedreamer_tpu/data/synthetic.py` (the reference's
batch contract of `Generator._get_batch` + `sample_camera`,
`imaginaire/generators/scenedreamer.py:80-283`): per sample a random
tour camera, its rays and their ray-voxel intersections (kernel K1 on
CUDA), the world encoder's BEV fields, and random stand-ins for the
pseudo ground truth and the real images, with reduced segmentation
masks from the first-hit voxel ids. Real training replaces the
stand-ins with SPADE outputs and photos.

The numpy draws happen in the JAX package's order from one
`numpy.random.default_rng(seed)`, so both packages build the same batch.
Tensors are NHWC on `device`. `make_paired_folder` writes a folder
dataset in the contract of `data/paired_dataset.py` with the port alone.
"""
import os

import numpy as np
import torch
import torch.nn.functional as F

from scenedreamer_tpu_torch.ops.ray_voxel import (camera_rays,
                                                  ray_voxel_intersection)
from scenedreamer_tpu_torch.scene import camera as cam
from scenedreamer_tpu_torch.scene import terrain, voxel_world
from scenedreamer_tpu_torch.scene.labels import mc2reduced
from scenedreamer_tpu_torch.utils.png import write_png


def make_world(size=128, seed=42, fill_depth=8, n_voronoi=40,
               relax_iters=2, boundary_detect=8):
    maps = terrain.generate_terrain(size=size, seed=seed,
                                    n_voronoi=n_voronoi,
                                    relax_iters=relax_iters)
    return voxel_world.build_voxel_world(
        maps.height_map, maps.semantic_map, maps.tree_map,
        fill_depth=fill_depth, seed=seed, boundary_detect=boundary_detect)


def make_batch(world, batch_size=2, height=34, width=34, max_samples=4,
               pad=2, num_labels=12, seed=0, include_gan_data=True,
               fov=26.0, device='cpu', voxel=None):
    """Build a training batch: a dict of NHWC tensors on `device`
    (`voxel`: the world's grid already on the device, to reuse one
    upload across batches). The batch's cameras are traced in one
    `ray_voxel_intersection` call."""
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    if voxel is None:
        voxel = torch.from_numpy(world.voxel).to(dev)
    f = 0.5 / np.tan(0.5 * np.deg2rad(fov))
    rds, oris = [], []
    for _ in range(batch_size):
        ori, d, up, _f = cam.rand_camera_pose_tour(world, rng)
        rds.append(camera_rays(d, up, f * (width - 1),
                               ((height - 1) / 2, (width - 1) / 2),
                               (height, width), device=dev))
        oris.append(torch.as_tensor(ori, dtype=torch.float32, device=dev))
    rd, ori = torch.stack(rds), torch.stack(oris)
    vid, dep, hit = ray_voxel_intersection(voxel, ori, rd.reshape(-1, 3),
                                           max_samples, image_width=width)
    shape = (batch_size, height, width, max_samples)
    data = dict(voxel_id=vid.reshape(shape), depth=dep.reshape(shape + (2,)),
                hit_mask=hit.reshape(shape), raydirs=rd, cam_ori=ori)
    for name, field in (('height_field', world.height_field),
                        ('semantic_field', world.semantic_field)):
        data[name] = torch.from_numpy(np.repeat(
            field.transpose(0, 2, 3, 1), batch_size, 0)).to(dev)
    if include_gan_data:
        crop_h, crop_w = height - pad, width - pad
        for name in ('pseudo_real_img', 'images'):
            data[name] = torch.from_numpy(rng.uniform(
                -1, 1, (batch_size, crop_h, crop_w, 3)).astype(
                    np.float32)).to(dev)
        # reduced-label masks from the first-hit voxel ids, cropped like
        # the images (reference scenedreamer.py:246-281)
        p0, p1 = pad // 2, pad - pad // 2
        reduced = mc2reduced(data['voxel_id'][..., 0], ign2dirt=True)
        reduced = reduced[:, p0:height - p1, p0:width - p1]
        onehot = F.one_hot(reduced, num_labels).to(torch.float32)
        data['fake_masks'] = onehot
        data['real_masks'] = onehot
    return data


def make_paired_folder(root, n=8, size=320, seed=0, num_labels=183):
    """Write `n` image / segmentation pairs of `size` x `size` as PNG
    under `root/images` and `root/seg_maps` (paired by stem): smooth
    random colour fields, and label maps of a few rectangles with labels
    in the coco range [0, num_labels) plus some 255 (dont-care)."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, 'images'), exist_ok=True)
    os.makedirs(os.path.join(root, 'seg_maps'), exist_ok=True)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    for i in range(n):
        freq = rng.uniform(1.0, 6.0, (3, 2)).astype(np.float32)
        phase = rng.uniform(0, 2 * np.pi, 3).astype(np.float32)
        img = np.stack([np.sin(2 * np.pi * (f[0] * yy + f[1] * xx) + p)
                        for f, p in zip(freq, phase)], -1)
        img = np.clip((img * 0.5 + 0.5) * 255, 0, 255).astype(np.uint8)
        seg = np.full((size, size), int(rng.integers(0, num_labels)),
                      np.uint8)
        for _ in range(6):
            y0, x0 = rng.integers(0, size - 8, 2)
            h, w = rng.integers(8, size // 2, 2)
            label = 255 if rng.random() < 0.15 \
                else int(rng.integers(0, num_labels))
            seg[y0:y0 + h, x0:x0 + w] = label
        write_png(os.path.join(root, 'images', f'{i:05d}.png'), img)
        write_png(os.path.join(root, 'seg_maps', f'{i:05d}.png'), seg)
    return root
