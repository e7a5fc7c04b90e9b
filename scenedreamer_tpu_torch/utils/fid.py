"""Frechet and kernel distances between feature sets (FID, KID).

Copy of `scenedreamer_tpu/utils/fid.py` (numpy float64 on the host; the
port keeps its own copy of the JAX package's numpy-only modules). The
reference wires FID hooks but its trainer returns None
(`imaginaire/trainers/base.py:553-563`, `:668-670`); these work over any
`[N, D]` features, which `cli/evaluate.py` extracts on the device. The
statistics (mean, covariance, a matrix square root by symmetric
eigendecomposition) are O(D^3) once per evaluation, not a device path.
"""
import numpy as np


def activation_statistics(feats):
    """feats [N, D] -> (mu [D], sigma [D, D]) in float64."""
    f = np.asarray(feats, np.float64)
    mu = f.mean(axis=0)
    sigma = np.cov(f, rowvar=False)
    if sigma.ndim == 0:          # D == 1
        sigma = sigma.reshape(1, 1)
    return mu, sigma


def frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6):
    """||mu1-mu2||^2 + Tr(s1 + s2 - 2 sqrt(s1 s2)).

    sqrtm via eigendecomposition with an eps jitter on the diagonal —
    no scipy dependency, robust to rank-deficient covariances.
    """
    mu1 = np.atleast_1d(np.asarray(mu1, np.float64))
    mu2 = np.atleast_1d(np.asarray(mu2, np.float64))
    sigma1 = np.atleast_2d(np.asarray(sigma1, np.float64))
    sigma2 = np.atleast_2d(np.asarray(sigma2, np.float64))
    d = sigma1.shape[0]
    off = np.eye(d) * eps
    s1 = sigma1 + off
    s2 = sigma2 + off
    # sqrt(s1) via symmetric eigendecomposition
    w, v = np.linalg.eigh(s1)
    sqrt_s1 = (v * np.sqrt(np.clip(w, 0, None))) @ v.T
    # sqrt(s1 s2 s1) is symmetric PSD; Tr(sqrt(s1 s2)) equals its trace
    m = sqrt_s1 @ s2 @ sqrt_s1
    wm = np.linalg.eigvalsh((m + m.T) / 2)
    tr_covmean = np.sum(np.sqrt(np.clip(wm, 0, None)))
    diff = mu1 - mu2
    return float(diff @ diff + np.trace(s1) + np.trace(s2)
                 - 2.0 * tr_covmean)


def compute_fid(real_feats, fake_feats):
    """FID between two feature sets [N, D]."""
    mu1, s1 = activation_statistics(real_feats)
    mu2, s2 = activation_statistics(fake_feats)
    return frechet_distance(mu1, s1, mu2, s2)


def _poly_kernel(x, y):
    """Cubic polynomial kernel (x·y/D + 1)^3 — the KID kernel."""
    d = x.shape[1]
    return (x @ y.T / d + 1.0) ** 3


def _mmd2_unbiased(x, y):
    """Unbiased MMD^2 estimator (Gretton et al. 2012, eq. 3)."""
    m, n = len(x), len(y)
    kxx = _poly_kernel(x, x)
    kyy = _poly_kernel(y, y)
    kxy = _poly_kernel(x, y)
    sum_xx = (kxx.sum() - np.trace(kxx)) / (m * (m - 1))
    sum_yy = (kyy.sum() - np.trace(kyy)) / (n * (n - 1))
    sum_xy = kxy.mean()
    return sum_xx + sum_yy - 2.0 * sum_xy


def compute_kid(real_feats, fake_feats, num_subsets=100,
                subset_size=1000, seed=0):
    """Kernel Inception Distance (Binkowski et al. 2018): mean unbiased
    polynomial-MMD^2 over random subsets — the SceneDreamer paper's
    second headline metric (the repo itself ships no evaluation; this
    exceeds parity like `compute_fid`). Returns (mean, std) over
    subsets; `subset_size` is clipped to the smaller feature set.
    """
    x = np.asarray(real_feats, np.float64)
    y = np.asarray(fake_feats, np.float64)
    n = min(subset_size, len(x), len(y))
    if n < 2:
        raise ValueError('KID needs at least 2 samples per set')
    if n == len(x) and n == len(y):
        # every "subset" would be a full permutation and MMD^2 is
        # permutation-invariant: compute once, std is exactly 0
        return float(_mmd2_unbiased(x, y)), 0.0
    rng = np.random.default_rng(seed)
    vals = np.empty(num_subsets)
    for i in range(num_subsets):
        xi = x[rng.choice(len(x), n, replace=False)]
        yi = y[rng.choice(len(y), n, replace=False)]
        vals[i] = _mmd2_unbiased(xi, yi)
    return float(vals.mean()), float(vals.std())
