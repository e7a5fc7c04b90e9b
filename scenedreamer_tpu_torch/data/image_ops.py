"""The OpenCV image operations of the dataset's augmentations, in numpy.

The JAX package's `Augmentor` (`scenedreamer_tpu/data/paired_dataset.py`)
calls OpenCV for `rotate` (`warpAffine`), `blur`, `motion_blur`
(`warpAffine` of a line kernel, then `filter2D`) and `compression` (a
JPEG round trip through `imencode` / `imdecode`). The port writes each
in numpy with OpenCV's own arithmetic:
  * `rotation_matrix` / `warp_affine`: `getRotationMatrix2D`, the inverse
    map of `invertAffineTransform`, float32 source coordinates and
    bilinear interpolation (OpenCV 4.11+), nearest by the rounded
    coordinate; borders reflect-101 or constant 0;
  * `box_blur`: `cv2.blur`, the window sum times 1/k^2, rounded;
  * `filter2d`: `cv2.filter2D` (a correlation, anchor at the centre,
    reflect-101), summed in float32 and rounded;
  * `jpeg_round_trip`: the lossy stages of baseline JPEG as libjpeg
    computes them (which OpenCV links): its fixed-point RGB -> YCbCr
    (the array's channels taken as BGR, as `imencode` takes them), edge
    replication to whole blocks, 4:2:0 subsampling by 2x2 means with
    alternating bias, the integer ("islow") DCT, quantisation with the
    IJG tables scaled by quality, then dequantisation, the integer
    inverse DCT, "fancy" (triangle) chroma upsampling and the
    fixed-point YCbCr -> RGB. Entropy coding is lossless and left out.
`resize_area` is `cv2.resize`'s INTER_AREA (the evaluation's resize),
`resize_cubic` its INTER_CUBIC on float32 (the synthetic training
images of `cli/campaign.py`).
Where OpenCV rounds in another order (float sums, vectorised paths), the
results can differ by a level; `tests/test_torch_augment.py` measures
each op against cv2 and states its tolerance.
"""
import math

import numpy as np

# ---------------------------------------------------------------------------
# borders
# ---------------------------------------------------------------------------


def reflect101(i, n):
    """Index `i` folded into [0, n) as BORDER_REFLECT_101 (gfedcb|abcdefgh
    |gfedcba)."""
    if n == 1:
        return np.zeros_like(i)
    period = 2 * n - 2
    i = np.abs(i) % period
    return np.where(i >= n, period - i, i)


# ---------------------------------------------------------------------------
# affine warps
# ---------------------------------------------------------------------------


def rotation_matrix(center, angle_deg, scale=1.0):
    """`cv2.getRotationMatrix2D`: [2, 3] float64, centre as float32."""
    cx, cy = (float(np.float32(c)) for c in center)
    a = math.radians(angle_deg)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _invert_affine(m):
    """`cv2.invertAffineTransform`."""
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[1, 1] * d, m[0, 0] * d
    a12, a21 = -m[0, 1] * d, -m[1, 0] * d
    b1 = -a11 * m[0, 2] - a12 * m[1, 2]
    b2 = -a21 * m[0, 2] - a22 * m[1, 2]
    return np.array([[a11, a12, b1], [a21, a22, b2]])


def _source_coords(minv, h, w):
    """Source coordinates of every destination pixel as OpenCV's
    `warpAffine` computes them (its float32 path): m0 * x + (m1 * y + m2)
    in float32, the last multiply-add rounded once."""
    m = minv.astype(np.float32)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)

    def row(r):
        inner = m[r, 1] * ys + m[r, 2]
        return (np.float64(m[r, 0]) * xs + inner).astype(np.float32)
    return row(0), row(1)


def warp_affine(img, m, nearest=False, border='reflect101'):
    """`cv2.warpAffine(img, m, (w, h), flags=INTER_LINEAR or
    INTER_NEAREST, borderMode=BORDER_REFLECT_101 or BORDER_CONSTANT (0))`
    of a uint8 or float32 [H, W] or [H, W, C] image (output its size):
    nearest takes the source pixel at the rounded coordinate; bilinear
    interpolates in float32 (x first, then y) and rounds a uint8 result
    half to even."""
    h, w = img.shape[:2]
    sx, sy = _source_coords(_invert_affine(np.asarray(m, np.float64)), h, w)
    squeeze = img.ndim == 2
    src = img[..., None] if squeeze else img
    if nearest:
        out = _fetch(src, np.rint(sy).astype(np.int64),
                     np.rint(sx).astype(np.int64), border)
        return out[..., 0] if squeeze else out
    x0, y0 = np.floor(sx), np.floor(sy)
    ax, ay = (sx - x0)[..., None], (sy - y0)[..., None]
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)

    def tap(dy, dx):
        return _fetch(src, y0 + dy, x0 + dx, border).astype(np.float32)
    p00, p01, p10, p11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
    top = p00 + ax * (p01 - p00)
    bottom = p10 + ax * (p11 - p10)
    out = top + ay * (bottom - top)
    if src.dtype == np.uint8:
        out = np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out[..., 0] if squeeze else out


def _fetch(src, yi, xi, border):
    h, w = src.shape[:2]
    if border == 'reflect101':
        return src[reflect101(yi, h), reflect101(xi, w)]
    inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
    vals = src[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)]
    return np.where(inside[..., None], vals, np.zeros_like(vals))


# ---------------------------------------------------------------------------
# filters
# ---------------------------------------------------------------------------


def _pad101(img, ry, rx):
    """Pad [H, W, C] by (ry, rx) on each side with reflect-101 borders
    (numpy's 'reflect'), or by folding indices when the image is
    smaller than the pad."""
    h, w = img.shape[:2]
    yi = reflect101(np.arange(-ry, h + ry), h)
    xi = reflect101(np.arange(-rx, w + rx), w)
    return img[yi][:, xi]


def box_blur(img, k):
    """`cv2.blur(img, (k, k))` of a uint8 [H, W, C] image: the k x k
    window mean over reflect-101 borders, rounded half to even."""
    r = k // 2
    pad = _pad101(img, r, r).astype(np.int64)
    c = np.cumsum(np.cumsum(pad, 0), 1)
    c = np.pad(c, ((1, 0), (1, 0), (0, 0)))
    h, w = img.shape[:2]
    s = c[k:k + h, k:k + w] - c[:h, k:k + w] - c[k:k + h, :w] + c[:h, :w]
    return np.clip(np.rint(s * (1.0 / (k * k))), 0, 255).astype(np.uint8)


def filter2d(img, kernel):
    """`cv2.filter2D(img, -1, kernel)` of a uint8 [H, W, C] image with a
    float32 [k, k] kernel: correlation, anchor at the centre, reflect-101
    borders, summed in float32 over the non-zero taps, rounded half to
    even."""
    kh, kw = kernel.shape
    ay, ax = kh // 2, kw // 2
    pad = _pad101(img, max(ay, kh - 1 - ay), max(ax, kw - 1 - ax))
    oy, ox = max(ay, kh - 1 - ay) - ay, max(ax, kw - 1 - ax) - ax
    h, w = img.shape[:2]
    acc = np.zeros(img.shape, np.float32)
    for i in range(kh):
        for j in range(kw):
            kv = np.float32(kernel[i, j])
            if kv != 0:
                acc += kv * pad[oy + i:oy + i + h,
                                ox + j:ox + j + w].astype(np.float32)
    return np.clip(np.rint(acc), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# JPEG round trip (libjpeg's lossy stages)
# ---------------------------------------------------------------------------

_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99])


def quant_table(base, quality):
    """`jpeg_set_quality`'s table: the IJG table scaled by quality,
    clamped to [1, 255] (baseline), as an [8, 8] int64 array."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255).reshape(8, 8)


_FIX = {n: int(v * 8192 + 0.5) for n, v in (
    ('0_298', 0.298631336), ('0_390', 0.390180644), ('0_541', 0.541196100),
    ('0_765', 0.765366865), ('0_899', 0.899976223), ('1_175', 1.175875602),
    ('1_501', 1.501321110), ('1_847', 1.847759065), ('1_961', 1.961570560),
    ('2_053', 2.053119869), ('2_562', 2.562915447), ('3_072', 3.072711026))}


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _odd(t0, t1, t2, t3):
    """The odd part shared by libjpeg's islow forward and inverse DCTs."""
    f = _FIX
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f['1_175']
    t0, t1 = t0 * f['0_298'], t1 * f['2_053']
    t2, t3 = t2 * f['3_072'], t3 * f['1_501']
    z1, z2 = z1 * -f['0_899'], z2 * -f['2_562']
    z3, z4 = z3 * -f['1_961'] + z5, z4 * -f['0_390'] + z5
    return t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4


def _fdct_1d(d, last):
    """One pass of `jpeg_fdct_islow` along axis -1 of int64 [..., 8]."""
    f = _FIX
    s = 13 + 2 if last else 13 - 2
    t0, t7 = d[..., 0] + d[..., 7], d[..., 0] - d[..., 7]
    t1, t6 = d[..., 1] + d[..., 6], d[..., 1] - d[..., 6]
    t2, t5 = d[..., 2] + d[..., 5], d[..., 2] - d[..., 5]
    t3, t4 = d[..., 3] + d[..., 4], d[..., 3] - d[..., 4]
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    out = [None] * 8
    out[0] = _descale(t10 + t11, 2) if last else (t10 + t11) << 2
    out[4] = _descale(t10 - t11, 2) if last else (t10 - t11) << 2
    z1 = (t12 + t13) * f['0_541']
    out[2] = _descale(z1 + t13 * f['0_765'], s)
    out[6] = _descale(z1 + t12 * -f['1_847'], s)
    o7, o5, o3, o1 = _odd(t4, t5, t6, t7)
    out[7], out[5] = _descale(o7, s), _descale(o5, s)
    out[3], out[1] = _descale(o3, s), _descale(o1, s)
    return np.stack(out, axis=-1)


def _idct_1d(c, last):
    """One pass of `jpeg_idct_islow` along axis -1 of int64 [..., 8]."""
    f = _FIX
    s = 13 + 2 + 3 if last else 13 - 2
    z1 = (c[..., 2] + c[..., 6]) * f['0_541']
    t2 = z1 + c[..., 6] * -f['1_847']
    t3 = z1 + c[..., 2] * f['0_765']
    t0 = (c[..., 0] + c[..., 4]) << 13
    t1 = (c[..., 0] - c[..., 4]) << 13
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    o0, o1, o2, o3 = _odd(c[..., 7], c[..., 5], c[..., 3], c[..., 1])
    out = [t10 + o3, t11 + o2, t12 + o1, t13 + o0,
           t13 - o0, t12 - o1, t11 - o2, t10 - o3]
    return np.stack([_descale(v, s) for v in out], axis=-1)


def _blocks(plane):
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def _unblocks(b):
    n, m = b.shape[:2]
    return b.transpose(0, 2, 1, 3).reshape(n * 8, m * 8)


def _code_plane(plane, q):
    """Level shift, forward DCT, quantise, dequantise, inverse DCT and
    shift back, of an int64 plane whose sides are multiples of 8."""
    b = _blocks(plane - 128)
    coef = _fdct_1d(np.swapaxes(_fdct_1d(b, False), -1, -2), True)
    coef = np.swapaxes(coef, -1, -2)
    div = q << 3
    mag = (np.abs(coef) + (div >> 1)) // div
    deq = np.where(coef < 0, -mag, mag) * q
    cols = _idct_1d(np.swapaxes(deq, -1, -2), False)      # [u, y]
    pix = _idct_1d(np.swapaxes(cols, -1, -2), True)         # [y, x]
    return np.clip(_unblocks(pix) + 128, 0, 255)


def _pad_edge(plane, h, w):
    return np.pad(plane, ((0, h - plane.shape[0]), (0, w - plane.shape[1])),
                  mode='edge')


def _fancy_upsample(c):
    """libjpeg's `h2v2_fancy_upsample`: each output sample 9/16, 3/16,
    3/16, 1/16 of its four nearest inputs, edges replicated, with the
    library's rounding biases."""
    up = np.concatenate([c[:1], c[:-1]])
    down = np.concatenate([c[1:], c[-1:]])
    rows = np.empty((2 * c.shape[0], c.shape[1]), np.int64)
    rows[0::2] = 3 * c + up
    rows[1::2] = 3 * c + down
    left = np.concatenate([rows[:, :1], rows[:, :-1]], axis=1)
    right = np.concatenate([rows[:, 1:], rows[:, -1:]], axis=1)
    out = np.empty((rows.shape[0], 2 * c.shape[1]), np.int64)
    out[:, 0::2] = (3 * rows + left + 8) >> 4
    out[:, 1::2] = (3 * rows + right + 7) >> 4
    return out


def jpeg_round_trip(img, quality):
    """The image `cv2.imdecode(cv2.imencode('.jpg', img, quality))` would
    give, up to OpenCV's last-level differences: uint8 [H, W, 3], its
    channels taken as B, G, R as `imencode` takes them, and returned in
    the same order."""
    h, w = img.shape[:2]
    b, g, r = (img[..., i].astype(np.int64) for i in range(3))
    one_half, off = 1 << 15, 128 << 16

    def fix(v):
        return int(v * 65536 + 0.5)
    y = (fix(0.299) * r + fix(0.587) * g + fix(0.114) * b + one_half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + off
          + one_half - 1) >> 16
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + off
          + one_half - 1) >> 16
    # whole MCUs (16 x 16) by edge replication; chroma: full-size rows to
    # an even count and columns to the MCU width, 2x2 means with libjpeg's
    # alternating bias 1, 2, 1, 2, ... along each row, then the last
    # subsampled row repeated to the MCU height
    hp, wp = -(-h // 16) * 16, -(-w // 16) * 16
    y_out = _code_plane(_pad_edge(y, hp, -(-w // 8) * 8),
                        quant_table(_LUMA_Q, quality))[:h, :w]
    bias = np.tile([1, 2], wp // 4)[None, :]
    chroma = []
    for c in (cb, cr):
        c = _pad_edge(c, h + h % 2, wp)
        c = (c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2] + c[1::2, 1::2]
             + bias) >> 2
        c = _code_plane(_pad_edge(c, hp // 2, wp // 2),
                        quant_table(_CHROMA_Q, quality))
        c = c[:-(-h // 2), :-(-w // 2)]
        chroma.append(_fancy_upsample(c)[:h, :w] - 128)
    cb, cr = chroma
    r = y_out + ((fix(1.40200) * cr + one_half) >> 16)
    g = y_out + ((-fix(0.34414) * cb + one_half - fix(0.71414) * cr) >> 16)
    b = y_out + ((fix(1.77200) * cb + one_half) >> 16)
    return np.clip(np.stack([b, g, r], axis=-1), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# area resize (cv2.INTER_AREA)
# ---------------------------------------------------------------------------


def _area_weights(n_in, n_out, scale):
    """[n_out, n_in] weights of OpenCV's `computeResizeAreaTab`: each
    output cell covers `scale` inputs, partial ones by their overlap,
    normalised by the cell's width (cut at the image's edge)."""
    w = np.zeros((n_out, n_in))
    for d in range(n_out):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_in - f1)
        s2 = min(math.floor(f2), n_in - 1)
        s1 = min(math.ceil(f1), s2)
        if s1 - f1 > 1e-3:
            w[d, s1 - 1] += np.float32((s1 - f1) / cell)
        w[d, s1:s2] += np.float32(1.0 / cell)
        if f2 - s2 > 1e-3:
            w[d, s2] += np.float32(min(f2 - s2, 1.0, cell) / cell)
    return w


def _area_linear_taps(n_in, n_out, scale):
    """OpenCV's INTER_AREA enlargement taps: source index sx = floor(d *
    scale) and its right neighbour, weights (1 - fx, fx) with
    fx = frac((d + 1) - (sx + 1) / scale) (0 when that is <= 0), the
    second tap dropped at the last input."""
    inv = n_out / n_in
    d = np.arange(n_out)
    sx = np.floor(d * scale).astype(np.int64)
    fx = ((d + 1) - (sx + 1) * inv).astype(np.float32)
    fx = np.where(fx <= 0, np.float32(0), fx - np.floor(fx))
    last = sx >= n_in - 1
    fx = np.where(last, np.float32(0), fx).astype(np.float32)
    sx = np.minimum(sx, n_in - 1)
    return sx, np.minimum(sx + 1, n_in - 1), fx


def resize_area(img, size_hw):
    """`cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)` of a uint8
    or float32 [H, W] or [H, W, C] image, by OpenCV's three branches:
      * an integer shrink on both axes: the block mean (`resizeAreaFast`;
        uint8 2x2 blocks (sum + 2) >> 2, other blocks the float32 sum
        times float32 1 / area, rounded half to even);
      * any other shrink on both axes: area-weighted (`resizeArea`),
        weights as OpenCV tabulates them, summed here in float64;
      * an enlargement on either axis: OpenCV's linear resize with the
        area taps (`_area_linear_taps`), horizontal then vertical; uint8
        in its 11-bit fixed point and its rounding, float32 in float32.
    The weighted branches round otherwise than OpenCV's float sums: up to
    one uint8 level, ~1e-6 in float32 (`tests/test_torch_evaluate.py`)."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    oh, ow = (int(s) for s in size_hw)
    if (oh, ow) == (h, w):
        return img.copy()
    is_u8 = img.dtype == np.uint8
    if not is_u8:
        img = img.astype(np.float32)
    sy, sx = 1.0 / (oh / h), 1.0 / (ow / w)
    squeeze = img.ndim == 2
    src = img[..., None] if squeeze else img
    if sx >= 1 and sy >= 1:
        iy, ix = int(round(sy)), int(round(sx))
        if abs(sy - iy) < 2.2e-16 and abs(sx - ix) < 2.2e-16:
            blocks = src[:oh * iy, :ow * ix].reshape(oh, iy, ow, ix, -1)
            if is_u8:
                total = blocks.astype(np.int64).sum(axis=(1, 3))
                if iy == ix == 2:
                    out = (total + 2) >> 2
                else:
                    out = np.rint(total.astype(np.float32)
                                  * np.float32(1.0 / (iy * ix)))
            else:
                total = blocks.transpose(0, 2, 1, 3, 4).reshape(
                    oh, ow, iy * ix, -1).sum(axis=2, dtype=np.float32)
                out = total * np.float32(1.0 / (iy * ix))
        else:
            wy, wx = _area_weights(h, oh, sy), _area_weights(w, ow, sx)
            out = np.einsum('yh,hwc,xw->yxc', wy, src.astype(np.float64),
                            wx, optimize=True)
            if is_u8:
                out = np.rint(out)
    else:
        y0, y1, fy = _area_linear_taps(h, oh, sy)
        x0, x1, fx = _area_linear_taps(w, ow, sx)
        if is_u8:
            one = 1 << 11
            ax0 = np.rint((1 - fx) * one).astype(np.int64)[None, :, None]
            ax1 = np.rint(fx * one).astype(np.int64)[None, :, None]
            by0 = np.rint((1 - fy) * one).astype(np.int64)[:, None, None]
            by1 = np.rint(fy * one).astype(np.int64)[:, None, None]
            s = src.astype(np.int64)
            rows = s[:, x0] * ax0 + s[:, x1] * ax1          # [H, OW, C]
            out = ((((rows[y0] >> 4) * by0) >> 16)
                   + (((rows[y1] >> 4) * by1) >> 16) + 2) >> 2
        else:
            rows = src[:, x0] * (1 - fx)[None, :, None] \
                + src[:, x1] * fx[None, :, None]
            out = rows[y0] * (1 - fy)[:, None, None] \
                + rows[y1] * fy[:, None, None]
    out = np.clip(out, 0, 255).astype(np.uint8) if is_u8 \
        else out.astype(np.float32)
    return out[..., 0] if squeeze else out


_CUBIC_A = np.float32(-0.75)
_CUBIC_LANES = 4    # floats per vector in OpenCV's baseline (SSE) build


def _cubic_taps(n_in, n_out):
    """OpenCV's cubic taps along one axis (`resize.cpp`: `interpolateCubic`
    with A = -0.75, the source coordinate (d + 0.5) * scale - 0.5 rounded
    to float32 from double, the weights in float32): source indices
    [n_out, 4], the border replicated, and the four weight vectors."""
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    f = f - s
    a, one, g = _CUBIC_A, np.float32(1), np.float32(1) - f
    x1 = f + one
    c0 = ((a * x1 - np.float32(5) * a) * x1 + np.float32(8) * a) * x1 \
        - np.float32(4) * a
    c1 = ((a + np.float32(2)) * f - (a + np.float32(3))) * f * f + one
    c2 = ((a + np.float32(2)) * g - (a + np.float32(3))) * g * g + one
    c3 = one - c0 - c1 - c2
    idx = np.clip(s.astype(np.int64)[:, None] + np.arange(-1, 3), 0,
                  n_in - 1)
    return idx, (c0, c1, c2, c3)


def resize_cubic(img, size_hw):
    """`cv2.resize(img, (w, h), interpolation=cv2.INTER_CUBIC)` of a
    float32 [H, W] image, as OpenCV's own C++ path computes it (bicubic
    with A = -0.75, half-pixel centres, border replicated): rows first,
    each output the four products summed first to last in float32; then
    columns, whose sum OpenCV's vector body (4 lanes) takes last to first
    and its scalar tail (the last W % 4 columns) first to last. Equal to
    cv2 with `cv2.ipp.setUseIPP(False)`; OpenCV's default IPP path
    computes its weights otherwise, within a few float32 steps
    (`tests/test_torch_campaign.py`)."""
    x = np.asarray(img, np.float32)
    h, w = (int(v) for v in size_hw)
    if (h, w) == x.shape:
        return x.copy()
    ix, cx = _cubic_taps(x.shape[1], w)
    rows = x[:, ix[:, 0]] * cx[0]
    for j in (1, 2, 3):
        rows = rows + x[:, ix[:, j]] * cx[j]
    iy, cy = _cubic_taps(x.shape[0], h)
    terms = [rows[iy[:, j]] * cy[j][:, None] for j in range(4)]
    out = ((terms[0] + terms[1]) + terms[2]) + terms[3]
    vec = w - w % _CUBIC_LANES
    out[:, :vec] = (((terms[3] + terms[2]) + terms[1])
                    + terms[0])[:, :vec]
    return out
