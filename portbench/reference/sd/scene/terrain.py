"""Procedural terrain generation (BEV height / semantic / tree maps).

Copy of `scenedreamer_tpu/scene/terrain.py` with its own
`assets/biome_lut.npz`; host numpy, so the maps equal the JAX
package's for the same seed.

Capability parity with the reference PCG pipeline (`terrain_generator.py`:
Voronoi biome cells with Lloyd relaxation and noise-warped boundaries,
temperature/precipitation -> biome lookup, per-biome bezier height
filtering, river carving along biome/cell boundaries, density-based tree
placement), re-implemented fully vectorized:

  * Voronoi rasterization + Lloyd relaxation run on the label grid via
    cKDTree nearest-site queries and bincount centroids (the reference
    rasterizes polygons per region and loops over pixels in Python).
  * Cell averages/fills are bincount gathers; boundary maps are
    max!=min filters (the reference uses O(size^2 * k^2) Python loops).
  * The temperature x precipitation -> biome table is baked into
    `assets/biome_lut.npz` (data table derived from the reference's
    lookup image, `terrain_generator.py:272-279`).

Outputs match the reference contract: `height_map` float (<0 means water),
`semantic_map` in {0..9} (9 = water), `tree_map` (255 = no tree, else
biome id), and a color map for visualization.
"""
import dataclasses
import functools
import os

import numpy as np
from scipy import ndimage
from scipy.spatial import cKDTree

from portbench.reference.sd.scene.noise import noise_map

_ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'assets')

BIOME_NAMES = [
    'desert', 'savanna', 'tropical_woodland', 'tundra', 'seasonal_forest',
    'rainforest', 'temperate_forest', 'temperate_rainforest',
    'boreal_forest',
]

BIOME_COLORS = np.array([
    [255, 255, 178], [184, 200, 98], [188, 161, 53], [190, 255, 242],
    [106, 144, 38], [33, 77, 41], [86, 179, 106], [34, 61, 53],
    [35, 114, 94]], np.uint8)

SEA_COLOR = np.array([12, 14, 255], np.uint8)

# per-biome bezier height-curve params (x1, y1, x2, y2, a, blend)
_BIOME_HEIGHT_PARAMS = [
    (0.75, 0.20, 0.95, 0.20, 0.20, 0.50),   # desert
    (0.50, 0.10, 0.95, 0.10, 0.10, 0.20),   # savanna
    (0.33, 0.33, 0.95, 0.10, 0.10, 0.75),   # tropical woodland
    (0.50, 1.00, 0.25, 1.00, 1.00, 1.00),   # tundra
    (0.75, 0.50, 0.40, 0.40, 0.33, 0.20),   # seasonal forest
    (0.50, 0.25, 0.66, 1.00, 1.00, 0.50),   # rainforest
    (0.75, 0.50, 0.40, 0.40, 0.33, 0.33),   # temperate forest
    (0.75, 0.50, 0.40, 0.40, 0.33, 0.33),   # temperate rainforest
    (0.80, 0.10, 0.90, 0.05, 0.05, 0.10),   # boreal
]

_TREE_DENSITIES = [4000, 1500, 8000, 1000, 10000, 25000, 10000, 20000, 5000]


@functools.lru_cache(maxsize=1)
def biome_lut():
    return np.load(os.path.join(_ASSET_DIR, 'biome_lut.npz'))['biome_lut']


@dataclasses.dataclass
class TerrainMaps:
    height_map: np.ndarray     # [S, S] float, <0 = water
    semantic_map: np.ndarray   # [S, S] uint8 in {0..9}
    tree_map: np.ndarray       # [S, S] uint8, 255 = no tree
    color_map: np.ndarray      # [S, S, 3] uint8


# --------------------------------------------------------------------------
# Voronoi machinery (grid-label based)
# --------------------------------------------------------------------------

def _voronoi_labels(points, size):
    """Nearest-site label for every pixel. Returns [size, size] int32
    indexed as [row, col] with points given as (row, col)."""
    ys, xs = np.mgrid[0:size, 0:size]
    grid = np.stack([ys.ravel(), xs.ravel()], -1)
    tree = cKDTree(points)
    _, lbl = tree.query(grid, k=1, workers=-1)
    return lbl.reshape(size, size).astype(np.int32)


def lloyd_relax(points, size, k=10, rng=None):
    """Lloyd relaxation on the rasterized Voronoi diagram: each iteration
    moves sites to the centroid of their pixel cell."""
    pts = np.asarray(points, np.float64)
    ys, xs = np.mgrid[0:size, 0:size]
    for _ in range(k):
        lbl = _voronoi_labels(pts, size)
        cnt = np.bincount(lbl.ravel(), minlength=len(pts)).astype(np.float64)
        sy = np.bincount(lbl.ravel(), weights=ys.ravel(), minlength=len(pts))
        sx = np.bincount(lbl.ravel(), weights=xs.ravel(), minlength=len(pts))
        nz = cnt > 0
        pts[nz, 0] = sy[nz] / cnt[nz]
        pts[nz, 1] = sx[nz] / cnt[nz]
    return pts


def average_cells(labels, data, n_cells):
    cnt = np.bincount(labels.ravel(), minlength=n_cells).astype(np.float64)
    s = np.bincount(labels.ravel(), weights=data.ravel(), minlength=n_cells)
    avg = s / (cnt + 1e-3)
    avg[cnt == 0] = 0
    return avg


def boundary_map(labels, kernel):
    """True where a (2k+1)-neighborhood contains more than one label."""
    size = 2 * kernel + 1
    mx = ndimage.maximum_filter(labels, size=size, mode='nearest')
    mn = ndimage.minimum_filter(labels, size=size, mode='nearest')
    return mx != mn


# --------------------------------------------------------------------------
# Height filtering
# --------------------------------------------------------------------------

def _bezier_lut(x1, y1, x2, y2, a):
    """Cubic bezier (0,0)-(x1,y1)-(x2,y2)-(1,a) sampled as an x->y LUT."""
    t = np.linspace(0.0, 1.0, 256)
    mt = 1.0 - t
    bx = 3 * mt ** 2 * t * x1 + 3 * mt * t ** 2 * x2 + t ** 3 * 1.0
    by = 3 * mt ** 2 * t * y1 + 3 * mt * t ** 2 * y2 + t ** 3 * a
    order = np.argsort(bx)
    return bx[order], by[order]


def _filter_height(h, h_smooth, params):
    x1, y1, x2, y2, a, blend = params
    bx, by = _bezier_lut(x1, y1, x2, y2, a)
    mixed = blend * h + (1.0 - blend) * h_smooth
    return np.interp(np.clip(mixed, 0.0, 1.0), bx, by)


def _histeq(img, alpha=1.0):
    """Histogram equalization to [-1, 1], blended with the input."""
    flat = img.ravel()
    order = np.argsort(flat)
    cdf = np.empty_like(flat)
    cdf[order] = np.arange(1, flat.size + 1) / flat.size
    eq = cdf.reshape(img.shape) * 2.0 - 1.0
    return alpha * eq + (1.0 - alpha) * img


# --------------------------------------------------------------------------
# Tree placement
# --------------------------------------------------------------------------

def _poisson_like_points(n, size, rng, relax_iters=4):
    pts = rng.integers(0, size - 1, (n, 2)).astype(np.float64)
    # a few Lloyd iterations spreads them evenly (blue-noise-ish)
    sub = max(1, size // 512)
    pts = lloyd_relax(pts / sub, size // sub, k=relax_iters, rng=rng) * sub
    return np.clip(pts, 0, size - 1).astype(np.int64)


# --------------------------------------------------------------------------
# Main pipeline
# --------------------------------------------------------------------------

def generate_terrain(size=1024, seed=3407, n_voronoi=514, relax_iters=12):
    """Generate one world's BEV maps. Deterministic in `seed`."""
    rng = np.random.default_rng(seed)
    map_seed = seed % 65536

    # 1. biome cells
    points = rng.integers(0, size, (n_voronoi, 2)).astype(np.float64)
    points = lloyd_relax(points, size, k=relax_iters)
    vor_map = _voronoi_labels(points, size)

    # noise-warp the cell boundaries
    disp = 8.0
    wy = noise_map(size, 32, 200 + map_seed, octaves=8)
    wx = noise_map(size, 32, 250 + map_seed, octaves=8)
    ys, xs = np.mgrid[0:size, 0:size]
    sy = np.clip(ys + disp * wy, 0, size - 1).astype(np.int64)
    sx = np.clip(xs + disp * wx, 0, size - 1).astype(np.int64)
    vor_map = vor_map[sy, sx]

    # 2. temperature / precipitation -> biome per cell
    temperature = _histeq(noise_map(size, 2, 10 + map_seed), alpha=0.33)
    precipitation = _histeq(noise_map(size, 2, 20 + map_seed), alpha=0.33)
    t_cells = average_cells(vor_map, temperature, n_voronoi)
    p_cells = average_cells(vor_map, precipitation, n_voronoi)

    def quantize(v, n=256):
        bins = np.linspace(-1, 1, n + 1)
        return np.clip(np.digitize(v, bins) - 1, 0, n - 1)

    lut = biome_lut()
    biome_cells = lut[quantize(t_cells), quantize(p_cells)].astype(np.int32)
    biome_map = biome_cells[vor_map]

    # 3. height maps
    height = noise_map(size, 4, 0 + map_seed, octaves=6)
    smooth_height = noise_map(size, 4, 0 + map_seed, octaves=1)
    land_mask = height > 0

    n_biomes = len(BIOME_NAMES)
    biome_masks = np.zeros((n_biomes, size, size))
    for b in range(n_biomes):
        biome_masks[b] = ndimage.gaussian_filter(
            (biome_map == b).astype(np.float64), sigma=16)
    blurred_land = ndimage.gaussian_filter(
        ndimage.binary_dilation(land_mask, iterations=32).astype(np.float64),
        sigma=16)
    biome_masks *= blurred_land

    adjusted = height.copy()
    for b in range(n_biomes):
        filtered = _filter_height(height, smooth_height,
                                  _BIOME_HEIGHT_PARAMS[b])
        adjusted = (1 - biome_masks[b]) * adjusted + biome_masks[b] * filtered

    # 4. rivers along biome/cell boundaries
    biome_bound = boundary_map(biome_map, kernel=5)
    cell_bound = boundary_map(vor_map, kernel=2)
    river_noise = noise_map(size, 4, 4353 + map_seed, octaves=6) > 0
    rivers = ((biome_bound & (adjusted < 0.5) & land_mask)
              | (cell_bound & (adjusted < 0.05) & land_mask)) & river_noise
    loose = ndimage.binary_dilation(rivers, iterations=8)
    river_depth = ndimage.gaussian_filter(
        rivers.astype(np.float64), sigma=2) * loose
    height_final = adjusted * (1 - river_depth) - 0.05 * rivers

    river_land = height_final >= 0
    semantic = np.where(river_land, biome_map, n_biomes).astype(np.uint8)
    color = np.where(river_land[..., None], BIOME_COLORS[biome_map],
                     SEA_COLOR[None, None])

    # 5. trees
    tree_map = np.full((size, size), 255, np.uint8)
    for b in range(n_biomes):
        n_trees = int(_TREE_DENSITIES[b] * (size / 1024.0) ** 2)
        if n_trees == 0:
            continue
        pts = _poisson_like_points(n_trees, size, rng)
        keep = (biome_masks[b][pts[:, 0], pts[:, 1]] > 0.5) \
            & river_land[pts[:, 0], pts[:, 1]] \
            & (height_final[pts[:, 0], pts[:, 1]] < 0.5)
        pts = pts[keep]
        tree_map[pts[:, 0], pts[:, 1]] = b

    return TerrainMaps(height_map=height_final.astype(np.float32),
                       semantic_map=semantic,
                       tree_map=tree_map,
                       color_map=color.astype(np.uint8))
