"""A small PNG writer and reader on zlib and numpy, so that snapshots,
rendered frames and the synthetic dataset need no image library.

The writer emits 8-bit grayscale or RGB, filter 0 on every row. The
reader takes non-interlaced 8-bit grayscale, RGB, palette and their
alpha variants (alpha dropped) with all five row filters; it is the
fallback of `data/paired_dataset.py` where neither OpenCV nor Pillow is
installed, and slow on files whose rows use the Average or Paeth filter
(a Python loop per pixel).
"""
import struct
import zlib

import numpy as np

_SIGNATURE = b'\x89PNG\r\n\x1a\n'


def write_png(path, img_uint8):
    """Write an [H, W, 3] RGB or [H, W] grayscale uint8 image as PNG."""
    img = np.ascontiguousarray(img_uint8, np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f'write_png takes [H, W] or [H, W, 3], got '
                         f'{img.shape}')
    h, w = img.shape[:2]
    color_type = 2 if img.ndim == 3 else 0
    raw = b''.join(b'\0' + img[y].tobytes() for y in range(h))

    def chunk(tag, data):
        body = tag + data
        return (struct.pack('>I', len(data)) + body
                + struct.pack('>I', zlib.crc32(body) & 0xffffffff))

    with open(path, 'wb') as f:
        f.write(_SIGNATURE
                + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, color_type,
                                             0, 0, 0))
                + chunk(b'IDAT', zlib.compress(raw, 4))
                + chunk(b'IEND', b''))


def _unfilter(rows, ftypes, bpp):
    """Undo the PNG row filters in place; rows [H, W*bpp] uint8."""
    h, n = rows.shape
    prev = np.zeros(n, np.uint8)
    for y in range(h):
        ft, cur = int(ftypes[y]), rows[y]
        if ft == 1:         # Sub: a running sum per channel, mod 256
            px = cur.reshape(-1, bpp).astype(np.uint64)
            cur[:] = (np.cumsum(px, axis=0) & 0xff).astype(np.uint8) \
                .reshape(-1)
        elif ft == 2:       # Up
            cur += prev
        elif ft in (3, 4):  # Average, Paeth: each pixel needs its left
            line = cur.astype(np.int32)
            up = prev.astype(np.int32)
            for i in range(n):
                a = line[i - bpp] if i >= bpp else 0
                if ft == 3:
                    pred = (a + up[i]) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + up[i] - c
                    pa, pb, pc = abs(p - a), abs(p - up[i]), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else \
                        (up[i] if pb <= pc else c)
                line[i] = (line[i] + pred) & 0xff
            cur[:] = line.astype(np.uint8)
        elif ft != 0:
            raise ValueError(f'bad PNG filter type {ft}')
        prev = cur
    return rows


def read_png(buf):
    """Decode PNG bytes to uint8 [H, W] (grayscale) or [H, W, 3] (RGB)."""
    if buf[:8] != _SIGNATURE:
        raise ValueError('not a PNG file')
    pos, idat, palette, header = 8, [], None, None
    while pos < len(buf):
        (length,), tag = struct.unpack('>I', buf[pos:pos + 4]), \
            buf[pos + 4:pos + 8]
        data = buf[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b'IHDR':
            header = struct.unpack('>IIBBBBB', data)
        elif tag == b'PLTE':
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif tag == b'IDAT':
            idat.append(data)
        elif tag == b'IEND':
            break
    w, h, depth, color_type, _, _, interlace = header
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(color_type)
    if depth != 8 or interlace or channels is None:
        raise ValueError('read_png takes non-interlaced 8-bit PNGs only '
                         f'(depth {depth}, color type {color_type}, '
                         f'interlace {interlace})')
    raw = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8) \
        .reshape(h, 1 + w * channels)
    rows = _unfilter(raw[:, 1:].copy(), raw[:, 0], channels)
    img = rows.reshape(h, w, channels)
    if color_type == 3:
        return palette[img[..., 0]]
    if color_type in (0, 4):
        return np.ascontiguousarray(img[..., 0])
    return np.ascontiguousarray(img[..., :3])
