"""Voxel world construction from BEV terrain maps.

Counterpart of `scenedreamer_tpu/scene/voxel_world.py` (`VoxelWorld`,
`build_voxel_world` and their helpers, and the training cache contract:
`save_world_cache`, `load_world_cache`, `WorldCache`). Host numpy: biome
-> minecraft-label column fill with a k-deep shell, procedural tree
stamping, camera heightmap, vertical crop to [ground, sky), int8 grid.
The renderer and the camera sampler move `voxel` to the device
themselves.
"""
import dataclasses
import os
import random

import numpy as np

SAMPLE_HEIGHT = 256
MC_WATER = 26

# biome id -> minecraft ground label (reference `pcg_gen.py:116`)
BIOME2MC = np.array([28, 9, 8, 1, 9, 8, 9, 8, 30, 26], dtype=np.int32)

# biome id -> usable tree model ids (reference `pcg_cache.py:31-42`)
BIOME_TREES = [[], [5], [1, 7], [], [1, 2], [1, 2, 3], [4], [0, 3],
               [5, 6, 7], []]

_LOG = {'oak': 34, 'spruce': 35, 'birch': 36, 'jungle': 37, 'acacia': 38,
        'dark_oak': 39}
_LEAF = {'oak': 58, 'spruce': 59, 'birch': 60, 'jungle': 61, 'acacia': 62,
         'dark_oak': 63}


def _blob_tree(trunk_h, radius, log_id, leaf_id, elongation=1.0):
    """Trunk + ellipsoidal canopy, [Y, X, Z] int32."""
    ry = max(1, int(round(radius * elongation)))
    h = trunk_h + 2 * ry + 1
    w = 2 * radius + 1
    t = np.zeros((h, w, w), np.int32)
    c = radius
    yy, xx, zz = np.mgrid[0:h, 0:w, 0:w]
    cy = trunk_h + ry
    canopy = (((yy - cy) / ry) ** 2 + ((xx - c) / radius) ** 2
              + ((zz - c) / radius) ** 2) <= 1.0
    t[canopy] = leaf_id
    t[:trunk_h + ry, c, c] = log_id
    return t


def _cone_tree(trunk_h, radius, height, log_id, leaf_id):
    """Conifer: trunk + linear cone of leaves, [Y, X, Z] int32."""
    h = trunk_h + height
    w = 2 * radius + 1
    t = np.zeros((h, w, w), np.int32)
    c = radius
    for lvl in range(height):
        r = max(0, int(round(radius * (1.0 - lvl / max(height - 1, 1)))))
        y = trunk_h + lvl
        xx, zz = np.mgrid[0:w, 0:w]
        disk = (xx - c) ** 2 + (zz - c) ** 2 <= r ** 2
        t[y][disk] = leaf_id
    t[:trunk_h + height - 1, c, c] = log_id
    return t


def _flat_tree(trunk_h, radius, log_id, leaf_id):
    """Acacia-style flat canopy, [Y, X, Z] int32."""
    h = trunk_h + 3
    w = 2 * radius + 1
    t = np.zeros((h, w, w), np.int32)
    c = radius
    xx, zz = np.mgrid[0:w, 0:w]
    disk = (xx - c) ** 2 + (zz - c) ** 2 <= radius ** 2
    t[trunk_h + 1][disk] = leaf_id
    t[trunk_h + 2][(xx - c) ** 2 + (zz - c) ** 2 <= (radius - 1) ** 2] \
        = leaf_id
    t[:trunk_h + 1, c, c] = log_id
    return t


def make_tree_models():
    """Eight procedural species in the slots of the reference's
    checkpoint assets (`pcg_cache.py:28`, ids 0..7)."""
    return [
        _blob_tree(4, 3, _LOG['dark_oak'], _LEAF['dark_oak']),      # 0
        _blob_tree(3, 2, _LOG['oak'], _LEAF['oak']),                # 1
        _blob_tree(5, 3, _LOG['jungle'], _LEAF['jungle'], 1.3),     # 2
        _blob_tree(7, 4, _LOG['jungle'], _LEAF['jungle'], 1.2),     # 3
        _blob_tree(4, 2, _LOG['birch'], _LEAF['birch'], 1.4),       # 4
        _flat_tree(4, 3, _LOG['acacia'], _LEAF['acacia']),          # 5
        _cone_tree(2, 2, 6, _LOG['spruce'], _LEAF['spruce']),       # 6
        _cone_tree(3, 3, 9, _LOG['spruce'], _LEAF['spruce']),       # 7
    ]


@dataclasses.dataclass
class VoxelWorld:
    """One scene's voxel + BEV state (host numpy)."""
    voxel: np.ndarray              # [Yc, S, S] int8, cropped to [gnd, sky)
    heightmap: np.ndarray          # [S, S] int32 heightmap (uncropped y)
    height_field: np.ndarray       # [1, 1, S, S] float32, world-encoder input
    semantic_field: np.ndarray     # [1, 11, S, S] float32 one-hot, ditto
    y_offset: int                  # world y of voxel[0]

    @property
    def dims(self):
        return self.voxel.shape

    def world2local(self, v):
        """World point -> cropped-voxel coordinates (y offset only)."""
        v = np.asarray(v, np.float32).copy()
        v[..., 0] -= self.y_offset
        return v

    def local2world(self, v):
        """Cropped-voxel coordinates -> world point (adds the y offset
        back)."""
        v = np.asarray(v, np.float32).copy()
        v[..., 0] += self.y_offset
        return v

    def is_sea(self, loc):
        """Whether the column under local point [y, x, z] is water at the
        heightmap's surface; a point outside the map counts as sea."""
        x, z = int(loc[1]), int(loc[2])
        hm = self.heightmap
        if x < 0 or x >= hm.shape[0] or z < 0 or z >= hm.shape[1]:
            return True
        y = int(np.clip(int(hm[x, z]) - self.y_offset, 0,
                        self.voxel.shape[0] - 1))
        return int(self.voxel[y, x, z]) == MC_WATER


def quantize_height(height_map, sample_height=SAMPLE_HEIGHT):
    """Reference height quantization (`pcg_cache.py:53-54`): clamp water
    to 0 then scale so that height 1.0 -> top level."""
    h = np.asarray(height_map, np.float64).copy()
    h[h < 0] = 0
    h = (h - h.min()) / (1.0 - h.min()) * (sample_height - 1)
    return h.astype(np.int32)


def calc_heightmap(voxel):
    """Y index of the highest non-empty voxel per column ([S, S] int32)."""
    occ = voxel != 0
    any_occ = occ.any(axis=0)
    top = voxel.shape[0] - 1 - np.argmax(occ[::-1], axis=0)
    return np.where(any_occ, top, 0).astype(np.int32)


def build_voxel_world(height_map, semantic_map, tree_map,
                      sample_height=SAMPLE_HEIGHT, fill_depth=16,
                      tree_models=None, seed=0, boundary_detect=50,
                      crop=True):
    """Construct a VoxelWorld from BEV maps (see
    `scenedreamer_tpu/scene/voxel_world.py:build_voxel_world`)."""
    size = height_map.shape[0]
    hq = quantize_height(height_map, sample_height)          # [S, S]
    mc_label = BIOME2MC[np.asarray(semantic_map, np.int64)]  # [S, S]

    ys = np.arange(sample_height, dtype=np.int32)[:, None, None]
    top = np.minimum(hq + fill_depth, sample_height - 1)
    occupied = (ys >= hq[None]) & (ys <= top[None])
    voxel = np.where(occupied, mc_label[None], 0).astype(np.int8)

    surface = hq + fill_depth                                 # [S, S]

    if tree_models is None:
        tree_models = make_tree_models()
    rng = random.Random(seed)
    tree_map = np.asarray(tree_map)
    for biome_id in range(len(BIOME_TREES)):
        choices = BIOME_TREES[biome_id]
        if not choices:
            continue
        px, py = np.nonzero(tree_map == biome_id)
        for x, z in zip(px.tolist(), py.tolist()):
            if (x < boundary_detect or x > size - boundary_detect
                    or z < boundary_detect or z > size - boundary_detect):
                continue
            h = int(surface[x, z])
            if h > sample_height - boundary_detect:
                continue
            model = tree_models[rng.choice(choices)]
            ty, tx, tz = model.shape
            region = voxel[h:h + ty, x:x + tx, z:z + tz]
            np.copyto(region, model[:region.shape[0], :region.shape[1],
                                    :region.shape[2]],
                      where=(region == 0))

    heightmap = calc_heightmap(voxel)

    # world-encoder BEV fields
    sem_tree = np.asarray(semantic_map, np.int64).copy()
    sem_tree[tree_map != 255] = 10
    onehot = np.zeros((11, size, size), np.float32)
    np.put_along_axis(onehot, sem_tree[None], 1.0, axis=0)
    height_field = (surface.astype(np.float32)
                    / (sample_height - 1))[None, None]

    if crop:
        gnd = int(heightmap.min())
        sky = int(heightmap.max()) + 1
    else:
        gnd, sky = 0, sample_height
    return VoxelWorld(voxel=np.ascontiguousarray(voxel[gnd:sky]),
                      heightmap=heightmap,
                      height_field=height_field,
                      semantic_field=onehot[None],
                      y_offset=gnd)


# --------------------------------------------------------------------------
# Cache contract (reference `scripts/pcg_cache.py:104-127`,
# `pcg_gen.py:26-45`)
# --------------------------------------------------------------------------

def save_world_cache(world, outdir):
    """Write the uncropped world in the reference's cache format."""
    os.makedirs(outdir, exist_ok=True)
    if world.y_offset != 0:
        raise ValueError('save uncropped worlds (crop=False)')
    v = world.voxel
    y, x, z = np.nonzero(v)
    sparse = np.stack([y, x, z, v[y, x, z]]).astype(np.int16)
    np.save(os.path.join(outdir, 'voxel_sparse.npy'), sparse)
    np.save(os.path.join(outdir, 'height_map.npy'), world.height_field)
    np.save(os.path.join(outdir, 'semantic_map.npy'), world.semantic_field)
    np.save(os.path.join(outdir, 'hmap_mc.npy'), world.heightmap)


def load_world_cache(world_dir, sample_height=SAMPLE_HEIGHT,
                     crop_height=None):
    """Load one cached world (densify COO, crop to [gnd, sky)).

    crop_height: if given, crop to a FIXED [gnd, gnd + crop_height)
    slab (zero-padded above the 256-level ceiling) instead of the
    world's own [gnd, sky). The reference's torch loop tolerates a
    different voxel height per world (`pcg_gen.py:43-46`);
    `WorldCache` passes the cache-wide max height here so every world
    of a cache has the same voxel dims (as in the JAX package, whose
    jitted step needs them static).
    """
    sparse = np.load(os.path.join(world_dir, 'voxel_sparse.npy'))
    height_field = np.load(os.path.join(world_dir, 'height_map.npy'))
    semantic_field = np.load(os.path.join(world_dir, 'semantic_map.npy'))
    heightmap = np.load(os.path.join(world_dir, 'hmap_mc.npy'))
    size = height_field.shape[-1]
    voxel = np.zeros((sample_height, size, size), np.int8)
    idx = sparse.astype(np.int64)
    voxel[idx[0], idx[1], idx[2]] = sparse[3]
    gnd = int(heightmap.min())
    sky = int(heightmap.max()) + 1
    if crop_height is not None:
        if crop_height < sky - gnd:
            raise ValueError(f'crop_height {crop_height} < world height '
                             f'{sky - gnd} in {world_dir}')
        sky = gnd + int(crop_height)
    if semantic_field.shape[1] < 11:  # pad tree channel if absent
        pad = np.zeros((1, 11 - semantic_field.shape[1], size, size),
                       semantic_field.dtype)
        semantic_field = np.concatenate([semantic_field, pad], axis=1)
    slab = voxel[gnd:sky]
    if slab.shape[0] < sky - gnd:    # fixed slab rises past level 256
        slab = np.concatenate(
            [slab, np.zeros((sky - gnd - slab.shape[0], size, size),
                            np.int8)], axis=0)
    return VoxelWorld(voxel=np.ascontiguousarray(slab),
                      heightmap=heightmap.astype(np.int32),
                      height_field=height_field.astype(np.float32),
                      semantic_field=semantic_field.astype(np.float32),
                      y_offset=gnd)


class WorldCache:
    """Directory of cached worlds; random sampling for training
    (reference PCGCache, `pcg_gen.py:10-57`).

    Every sampled world is cropped to the same height slab (the max
    [gnd, sky) span over the cache, scanned once from the small
    `hmap_mc.npy` files at init), so voxel dims stay the same across
    per-iteration world swaps and multi-world batches can be stacked."""

    def __init__(self, cache_dir, uniform_height=True):
        self.paths = sorted(
            os.path.join(cache_dir, p) for p in os.listdir(cache_dir)
            if os.path.isdir(os.path.join(cache_dir, p)))
        if not self.paths:
            raise FileNotFoundError(f'no cached worlds in {cache_dir}')
        self.slab_height = None
        if uniform_height:
            spans = []
            for p in self.paths:
                hm = np.load(os.path.join(p, 'hmap_mc.npy'))
                spans.append(int(hm.max()) - int(hm.min()) + 1)
            self.slab_height = max(spans)

    def sample_world(self, rng=None):
        rng = rng or random
        return load_world_cache(rng.choice(self.paths),
                                crop_height=self.slab_height)
