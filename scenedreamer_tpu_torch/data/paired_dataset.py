"""Paired image + segmentation dataset with augmentations.

Counterpart of `scenedreamer_tpu/data/paired_dataset.py` (reference
`imaginaire/utils/data.py` Augmentor: resize_smallest_side 256,
random_scale_limit 0.2, hflip, random_crop 256x256,
`configs/scenedreamer_train.yaml:198-207`; `imaginaire/model_utils/
label.py:8-41` make_one_hot / concat_labels):

  * folder backend: `root/images/*` + `root/seg_maps/*` paired by stem;
    LMDB backend: the raw-bytes databases `root/images` and
    `root/seg_maps` of `data/lmdb_utils.py` (the real LMDB format where
    the `lmdb` package is installed, else its sqlite substitute), paired
    by the stems of their keys
  * joint augmentations applied identically to image (linear) and mask
    (nearest), seeded per item by (seed, epoch, index), with the JAX
    package's order of random draws
  * `make_one_hot` / `concat_labels`
  * a host-side loader: shuffled epochs, per-process sharding, a thread
    pool with a prefetch depth; NHWC numpy batches.

Host side by design: decode and augment are CPU work that feeds the
training step; the training CLI moves each batch to the device.

The augmentations are written without OpenCV (absent where the port
runs): `data/image_ops.py` holds the numpy counterparts of its warps,
filters and JPEG round trip, and the Augmentor draws from its numpy
generator in exactly the JAX package's order, the draws of an op that
its probability then skips included. Resizing uses torch on CPU tensors
and numpy index maps:
bilinear with half-pixel centres and no antialiasing, rounded to uint8
(= `cv2.INTER_LINEAR` up to its fixed-point rounding, one uint8 level),
and nearest with source index floor(dst * in/out) (`cv2.INTER_NEAREST`).
Files are decoded with OpenCV, else Pillow, else, for PNG, the reader of
`utils/png.py`; a JPEG without either library raises an ImportError.
"""
import collections
import concurrent.futures as cf
import dataclasses
import os

import numpy as np
import torch
import torch.nn.functional as F

from scenedreamer_tpu_torch.data import image_ops
from scenedreamer_tpu_torch.utils.png import read_png


@dataclasses.dataclass
class AugmentConfig:
    """`configs/scenedreamer_train.yaml:198-207`."""
    resize_smallest_side: int = 256
    random_scale_limit: float = 0.2
    horizontal_flip: bool = True
    random_crop_h_w: tuple = (256, 256)

    def to_ops(self):
        """Ordered op dict equivalent (the yaml order the reference
        feeds `_build_augmentation_ops`, `utils/data.py:93-175`)."""
        ops = {}
        if self.resize_smallest_side:
            ops['resize_smallest_side'] = self.resize_smallest_side
        if self.random_scale_limit:
            ops['random_scale_limit'] = self.random_scale_limit
        if self.horizontal_flip:
            ops['horizontal_flip'] = True
        if self.random_crop_h_w:
            ops['random_crop_h_w'] = tuple(self.random_crop_h_w)
        return ops


def make_one_hot(seg, num_classes=183, use_dont_care=True):
    """[H, W] int mask -> [H, W, num_classes(+1)] one-hot; values outside
    [0, num_classes) go to the trailing dont-care channel
    (`model_utils/label.py:8-24`)."""
    total = num_classes + (1 if use_dont_care else 0)
    seg = np.asarray(seg, np.int64)
    if use_dont_care:
        seg = np.where((seg < 0) | (seg >= num_classes), num_classes, seg)
    else:
        seg = np.clip(seg, 0, num_classes - 1)
    out = np.zeros(seg.shape + (total,), np.float32)
    np.put_along_axis(out, seg[..., None], 1.0, axis=-1)
    return out


def concat_labels(data, label_keys=('seg_maps',)):
    """Concatenate one-hot label tensors into data['label']
    (`model_utils/label.py:27-41`)."""
    data['label'] = np.concatenate([data[k] for k in label_keys], axis=-1)
    return data


def resize_linear(image, nh, nw):
    """uint8 [H, W, C] -> [nh, nw, C]: bilinear, half-pixel centres, no
    antialiasing, rounded to nearest."""
    x = torch.from_numpy(np.ascontiguousarray(image)).permute(2, 0, 1)[None]
    y = F.interpolate(x.to(torch.float32), size=(nh, nw), mode='bilinear',
                      align_corners=False, antialias=False)
    y = torch.floor(y + 0.5).clamp(0, 255).to(torch.uint8)
    return y[0].permute(1, 2, 0).numpy()


def resize_nearest(seg, nh, nw):
    """[H, W] -> [nh, nw]: source index min(floor(dst * (1 / (out/in))),
    in - 1) in float64, as `cv2.INTER_NEAREST` computes it."""
    h, w = seg.shape[:2]

    def index(n_in, n_out):
        inv = 1.0 / (n_out / n_in)
        return np.minimum(np.floor(np.arange(n_out) * inv).astype(np.int64),
                          n_in - 1)
    return seg[index(h, nh)][:, index(w, nw)]


_OPS = ('resize_smallest_side', 'resize_h_w', 'random_resize_h_w_aspect',
        'rotate', 'random_rotate_90', 'random_scale_limit',
        'random_crop_h_w', 'center_crop_h_w', 'horizontal_flip', 'contrast',
        'blur', 'gamma', 'motion_blur', 'compression', 'max_time_step')


class Augmentor:
    """Joint image+mask augmentation pipeline (reference
    `utils/data.py:93-175` `_build_augmentation_ops`), op for op the JAX
    package's: resize_smallest_side, resize_h_w, random_resize_h_w_aspect,
    rotate, random_rotate_90, random_scale_limit (a scalar: factor in
    [1, 1+limit], `utils/data.py:127`; a dict {scale_limit_lb,
    scale_limit_ub, p}: [1-lb, 1+ub] with probability p, the video-frame
    variant, `utils/data.py:76-84`), random_crop_h_w, center_crop_h_w,
    horizontal_flip, and on the image only contrast, blur, gamma,
    motion_blur and compression; max_time_step is accepted and ignored
    (video datasets only). Ops apply in dict order like the yaml,
    geometry jointly to the uint8 image (linear) and seg (nearest). An
    unknown key raises ValueError."""

    def __init__(self, cfg=None):
        cfg = AugmentConfig() if cfg is None else cfg
        self.cfg = cfg
        self.ops = cfg if isinstance(cfg, dict) else cfg.to_ops()
        for key in self.ops:
            if key not in _OPS:
                raise ValueError(f'Unknown augmentation {key}')
        # guarantee a deterministic final shape when a crop is present
        self.crop = None
        for k in ('random_crop_h_w', 'center_crop_h_w'):
            if k in self.ops:
                self.crop = tuple(self.ops[k])

    def _resize(self, image, seg, nh, nw):
        if self.crop:
            nh = max(nh, self.crop[0])
            nw = max(nw, self.crop[1])
        return resize_linear(image, nh, nw), resize_nearest(seg, nh, nw)

    def __call__(self, image, seg, rng):
        for key, value in self.ops.items():
            image, seg = self._apply(key, value, image, seg, rng)
        return np.ascontiguousarray(image), np.ascontiguousarray(seg)

    def _apply(self, key, value, image, seg, rng):
        h, w = image.shape[:2]
        if key == 'resize_smallest_side':
            s = value / min(h, w)
            return self._resize(image, seg, int(round(h * s)),
                                int(round(w * s)))
        if key == 'resize_h_w':
            return self._resize(image, seg, value[0], value[1])
        if key == 'rotate':
            if value:
                mat = image_ops.rotation_matrix(
                    (w / 2, h / 2), rng.uniform(-value, value))
                image = image_ops.warp_affine(image, mat)
                seg = image_ops.warp_affine(seg, mat, nearest=True)
        elif key == 'random_rotate_90':
            if rng.random() < 0.5:
                k = int(rng.integers(0, 4))
                image, seg = np.rot90(image, k), np.rot90(seg, k)
        elif key == 'random_scale_limit':
            if value:
                if isinstance(value, dict):
                    lb, ub = value['scale_limit_lb'], value['scale_limit_ub']
                    p = value.get('p', 1.0)
                else:
                    lb, ub, p = 0.0, value, 1.0
                if rng.random() < p:
                    s = 1.0 + rng.uniform(-lb, ub)
                    image, seg = self._resize(image, seg, int(round(h * s)),
                                              int(round(w * s)))
        elif key in ('random_crop_h_w', 'center_crop_h_w'):
            ch, cw = value
            if key == 'random_crop_h_w':
                y0 = rng.integers(0, h - ch + 1)
                x0 = rng.integers(0, w - cw + 1)
            else:
                y0, x0 = (h - ch) // 2, (w - cw) // 2
            image = image[y0:y0 + ch, x0:x0 + cw]
            seg = seg[y0:y0 + ch, x0:x0 + cw]
        elif key == 'horizontal_flip':
            if value and rng.random() < 0.5:
                image, seg = image[:, ::-1], seg[:, ::-1]
        elif key == 'random_resize_h_w_aspect':
            return self._resized_crop(value, image, seg, rng)
        elif key != 'max_time_step':
            image = self._photometric(key, value, image, rng)
        return image, seg

    def _resized_crop(self, value, image, seg, rng):
        """alb.RandomResizedCrop(scale=(1, 1), ratio=(lo, hi))
        (`utils/data.py:111-121`): the largest window of a random aspect
        ratio, both sides scaled into the image, resized to (h, w)."""
        h, w = image.shape[:2]
        lo, hi = value['aspect_min'], value['aspect_max']
        ratio = np.exp(rng.uniform(np.log(lo), np.log(hi)))
        cw, ch = np.sqrt(h * w * ratio), np.sqrt(h * w / ratio)
        s = min(1.0, w / cw, h / ch)
        cw, ch = max(1, int(round(cw * s))), max(1, int(round(ch * s)))
        y0 = int(rng.integers(0, h - ch + 1))
        x0 = int(rng.integers(0, w - cw + 1))
        return self._resize(image[y0:y0 + ch, x0:x0 + cw],
                            seg[y0:y0 + ch, x0:x0 + cw],
                            value['h'], value['w'])

    @staticmethod
    def _photometric(key, value, image, rng):
        """contrast, blur, gamma, motion_blur, compression: each drawn
        with probability `p` (the draw made whatever it decides)."""
        if not rng.random() < value.get('p', 1.0):
            return image
        if key == 'contrast':
            b = rng.uniform(-value['brightness_limit'],
                            value['brightness_limit'])
            ct = rng.uniform(-value['contrast_limit'], value['contrast_limit'])
            img_f = image.astype(np.float32)
            mean = img_f.mean()
            img_f = (img_f - mean) * (1 + ct) + mean + 255 * b
            return np.clip(img_f, 0, 255).astype(image.dtype)
        if key == 'blur':
            k = int(rng.integers(3, max(value['blur_limit'], 3) + 1)) | 1
            return image_ops.box_blur(image, k)
        if key == 'gamma':
            g = rng.uniform(value['gamma_limit_lb'],
                            value['gamma_limit_ub']) / 100.0
            img_f = image.astype(np.float32) / 255.0
            return np.clip(img_f ** g * 255, 0, 255).astype(image.dtype)
        if key == 'motion_blur':
            # alb.MotionBlur: a line kernel of odd size in [3, blur_limit]
            # along a random axis, rotated by a random angle
            kmax = max(int(value['blur_limit']), 3)
            k = int(rng.choice(np.arange(3, kmax + 1, 2)))
            kern = np.zeros((k, k), np.float32)
            if rng.random() < 0.5:
                kern[k // 2, :] = 1.0
            else:
                kern[:, k // 2] = 1.0
            mat = image_ops.rotation_matrix((k / 2 - 0.5, k / 2 - 0.5),
                                            float(rng.uniform(0, 360)))
            kern = image_ops.warp_affine(kern, mat, border='constant')
            kern /= max(kern.sum(), 1e-6)
            return image_ops.filter2d(image, kern)
        # compression: alb.ImageCompression, a JPEG round trip
        q = int(rng.integers(value['quality_lower'],
                             value.get('quality_upper', 100) + 1))
        return image_ops.jpeg_round_trip(image, q)


def _luma(rgb):
    """RGB -> gray as OpenCV and Pillow weigh it, rounded."""
    return np.floor(rgb.astype(np.float64) @ [0.299, 0.587, 0.114]
                    + 0.5).astype(np.uint8)


def decode_image(buf, gray=False):
    """Encoded bytes -> uint8 RGB [H, W, 3], or [H, W] with `gray`."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imdecode(np.frombuffer(buf, np.uint8),
                           cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
        if img is None:
            raise ValueError('failed to decode image buffer')
        return img if gray else img[..., ::-1]             # BGR -> RGB
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is not None:
        import io
        return np.asarray(Image.open(io.BytesIO(buf))
                          .convert('L' if gray else 'RGB'))
    if buf[:4] != b'\x89PNG':
        raise ImportError('decoding a non-PNG image needs the cv2 (OpenCV) '
                          'or PIL (Pillow) package; neither is installed')
    img = read_png(buf)
    if gray:
        return img if img.ndim == 2 else _luma(img)
    return img if img.ndim == 3 else np.repeat(img[..., None], 3, -1)


class _FolderBackend:
    def __init__(self, root, image_dir='images', seg_dir='seg_maps'):
        self.image_root = os.path.join(root, image_dir)
        self.seg_root = os.path.join(root, seg_dir)
        imgs = {os.path.splitext(f)[0]: f
                for f in sorted(os.listdir(self.image_root))}
        segs = {os.path.splitext(f)[0]: f
                for f in sorted(os.listdir(self.seg_root))}
        self.stems = sorted(set(imgs) & set(segs))
        if not self.stems:
            raise FileNotFoundError(f'no paired files under {root}')
        self._imgs, self._segs = imgs, segs

    def __len__(self):
        return len(self.stems)

    def read(self, i):
        stem = self.stems[i]
        with open(os.path.join(self.image_root, self._imgs[stem]),
                  'rb') as f:
            img_buf = f.read()
        with open(os.path.join(self.seg_root, self._segs[stem]),
                  'rb') as f:
            seg_buf = f.read()
        return img_buf, seg_buf


class _LMDBBackend:
    """Two raw-bytes databases (images, seg_maps) sharing their keys'
    stems (reference `utils/lmdb.py:43-74`)."""

    def __init__(self, root, image_dir='images', seg_dir='seg_maps'):
        from scenedreamer_tpu_torch.data.lmdb_utils import LMDBReader
        self.images = LMDBReader(os.path.join(root, image_dir))
        self.segs = LMDBReader(os.path.join(root, seg_dir))
        img_stems = {os.path.splitext(k)[0]: k for k in self.images.keys}
        seg_stems = {os.path.splitext(k)[0]: k for k in self.segs.keys}
        self.stems = sorted(set(img_stems) & set(seg_stems))
        if not self.stems:
            raise FileNotFoundError(f'no paired entries under {root}')
        self._imap, self._smap = img_stems, seg_stems

    def __len__(self):
        return len(self.stems)

    def read(self, i):
        stem = self.stems[i]
        return (self.images.get(self._imap[stem]),
                self.segs.get(self._smap[stem]))


class PairedImageDataset:
    """images + seg_maps -> {'images': [-1,1] float32 HWC,
    'label': one-hot 184ch HWC} (numpy)."""

    def __init__(self, root, dataset_type='folder',
                 augment: AugmentConfig = AugmentConfig(),
                 num_seg_classes=183, use_dont_care=True, seed=0):
        if dataset_type == 'folder':
            self.backend = _FolderBackend(root)
        elif dataset_type == 'lmdb':
            self.backend = _LMDBBackend(root)
        else:
            raise ValueError(f'unknown dataset_type {dataset_type}')
        self.augmentor = Augmentor(augment) if augment else None
        self.num_seg_classes = num_seg_classes
        self.use_dont_care = use_dont_care
        self.seed = seed

    def __len__(self):
        return len(self.backend)

    def __getitem__(self, i, epoch=0):
        img_buf, seg_buf = self.backend.read(i)
        img = decode_image(img_buf)
        seg = decode_image(seg_buf, gray=True)
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + epoch) * 1_000_003 + i)
        if self.augmentor is not None:
            img, seg = self.augmentor(img, seg, rng)
        data = {
            'images': img.astype(np.float32) / 127.5 - 1.0,
            'seg_maps': make_one_hot(seg, self.num_seg_classes,
                                     self.use_dont_care),
        }
        return concat_labels(data)


class DataLoader:
    """Shuffling, process-sharding batch iterator (reference torch
    DataLoader + DistributedSampler, `utils/dataset.py:13-87`).

    `num_workers > 0` decodes/augments items on a thread pool and keeps
    `prefetch_batches` batches in flight ahead of the consumer. Threads,
    not processes: decode and resize release the GIL, and the per-item
    rng is seeded by (seed, epoch, index), so batches are bit-identical
    to the synchronous path in the same order."""

    def __init__(self, dataset, batch_size, shuffle=True, seed=0,
                 process_index=0, process_count=1, drop_last=True,
                 num_workers=0, prefetch_batches=2):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.pidx = process_index
        self.pcount = process_count
        self.drop_last = drop_last
        self.num_workers = int(num_workers)
        self.prefetch_batches = max(1, int(prefetch_batches))
        self.epoch = 0
        self.start_batch = 0

    def set_epoch(self, epoch, start_batch=0):
        """Iterate epoch `epoch` from its batch `start_batch` (a resumed
        run skips the batches it has trained on without loading them)."""
        self.epoch, self.start_batch = epoch, start_batch

    def __len__(self):
        per = len(self.ds) // self.pcount
        return per // self.batch_size if self.drop_last \
            else -(-per // self.batch_size)

    def _batch_indices(self):
        idx = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        idx = idx[self.pidx::self.pcount]
        n = len(idx) // self.batch_size * self.batch_size \
            if self.drop_last else len(idx)
        return [idx[s:s + self.batch_size]
                for s in range(0, n, self.batch_size)]

    @staticmethod
    def _stack(items):
        return {k: np.stack([it[k] for it in items]) for k in items[0]}

    def __iter__(self):
        batches = self._batch_indices()[self.start_batch:]
        epoch = self.epoch
        if self.num_workers <= 0:
            for b in batches:
                yield self._stack([self.ds.__getitem__(int(i), epoch=epoch)
                                   for i in b])
            return
        pool = cf.ThreadPoolExecutor(self.num_workers)
        try:
            pending = collections.deque()

            def submit(b):
                pending.append([pool.submit(self.ds.__getitem__, int(i),
                                            epoch=epoch) for i in b])
            depth = min(self.prefetch_batches, len(batches))
            for b in batches[:depth]:
                submit(b)
            nxt = depth
            while pending:
                futs = pending.popleft()
                if nxt < len(batches):    # refill BEFORE blocking so the
                    submit(batches[nxt])  # pool stays `depth` ahead
                    nxt += 1
                yield self._stack([f.result() for f in futs])
        finally:
            # abandoning the iterator mid-epoch (--max-iter break, a
            # termination checkpoint) must not wait out the prefetched
            # decodes: drop queued work, don't join running threads
            pool.shutdown(wait=False, cancel_futures=True)
