"""Vectorized 3D simplex noise + fractal Brownian motion (numpy).

Copy of `scenedreamer_tpu/scene/noise.py` (the port imports nothing of
the JAX package); same permutation table, so the same maps.

Replaces the reference's dependency on the C `noise` package
(`terrain_generator.py:89-102` uses `snoise3(x, y, seed, octaves, ...)`
with the seed passed as the z coordinate). This is a from-scratch
vectorized implementation of Gustavson-style simplex noise: same value
range (~[-1, 1]) and spectral character, evaluated for whole maps at once
instead of per-pixel Python loops.
"""
import numpy as np

_F3 = 1.0 / 3.0
_G3 = 1.0 / 6.0

# gradient directions: 12 edge midpoints of a cube
_GRAD3 = np.array([
    [1, 1, 0], [-1, 1, 0], [1, -1, 0], [-1, -1, 0],
    [1, 0, 1], [-1, 0, 1], [1, 0, -1], [-1, 0, -1],
    [0, 1, 1], [0, -1, 1], [0, 1, -1], [0, -1, -1]], dtype=np.float64)

_rng = np.random.default_rng(20240613)
_PERM = _rng.permutation(256)
_PERM = np.concatenate([_PERM, _PERM]).astype(np.int64)


def _gindex(i, j, k):
    return _PERM[(i + _PERM[(j + _PERM[k & 255]) & 255]) & 255] % 12


def simplex3(x, y, z):
    """Simplex noise at (x, y, z); arrays broadcast elementwise."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    z = np.asarray(z, np.float64)

    s = (x + y + z) * _F3
    i = np.floor(x + s).astype(np.int64)
    j = np.floor(y + s).astype(np.int64)
    k = np.floor(z + s).astype(np.int64)
    t = (i + j + k) * _G3
    x0 = x - (i - t)
    y0 = y - (j - t)
    z0 = z - (k - t)

    # rank the components to pick the simplex traversal order
    gx = (x0 >= y0).astype(np.int64)
    gy = (y0 >= z0).astype(np.int64)
    gz = (x0 >= z0).astype(np.int64)
    i1 = gx & gz
    j1 = (1 - gx) & gy
    k1 = (1 - gy) & (1 - gz)
    i2 = gx | (gy & gz)
    j2 = gy | ((1 - gx) & (1 - gz))
    k2 = 1 - (gy & gz)
    # The above boolean identities reproduce the classic 6-branch table.
    # (verified against the scalar reference in tests)

    x1 = x0 - i1 + _G3
    y1 = y0 - j1 + _G3
    z1 = z0 - k1 + _G3
    x2 = x0 - i2 + 2.0 * _G3
    y2 = y0 - j2 + 2.0 * _G3
    z2 = z0 - k2 + 2.0 * _G3
    x3 = x0 - 1.0 + 3.0 * _G3
    y3 = y0 - 1.0 + 3.0 * _G3
    z3 = z0 - 1.0 + 3.0 * _G3

    out = np.zeros(np.broadcast(x, y, z).shape, np.float64)
    for (dx, dy, dz, oi, oj, ok) in (
            (x0, y0, z0, 0, 0, 0), (x1, y1, z1, i1, j1, k1),
            (x2, y2, z2, i2, j2, k2), (x3, y3, z3, 1, 1, 1)):
        tt = 0.6 - dx * dx - dy * dy - dz * dz
        gi = _gindex(i + oi, j + oj, k + ok)
        g = _GRAD3[gi]
        contrib = (tt ** 4) * (g[..., 0] * dx + g[..., 1] * dy
                               + g[..., 2] * dz)
        out += np.where(tt > 0, contrib, 0.0)
    return 32.0 * out


def fbm3(x, y, z, octaves=1, persistence=0.5, lacunarity=2.0):
    """Fractal sum of simplex3, normalized to ~[-1, 1]."""
    total = np.zeros(np.broadcast(x, y, z).shape, np.float64)
    amp, freq, norm = 1.0, 1.0, 0.0
    for _ in range(octaves):
        total += amp * simplex3(x * freq, y * freq, z * freq)
        norm += amp
        amp *= persistence
        freq *= lacunarity
    return total / norm


def noise_map(size, res, seed, octaves=1, persistence=0.5, lacunarity=2.0):
    """2D noise field with the reference's parameterization
    (`terrain_generator.py:89-102`): scale = size/res, seed as z-plane.

    Uses the native C++/OpenMP kernel (`native/simplex.cpp`) when it
    compiles; identical output from the numpy path otherwise."""
    scale = size / res
    ys, xs = np.mgrid[0:size, 0:size]
    return fbm3((xs + 0.1) / scale, ys / scale, np.float64(seed),
                octaves=octaves, persistence=persistence,
                lacunarity=lacunarity)
