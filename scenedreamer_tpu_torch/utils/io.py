"""IO helpers: image save, checkpoint resolution.

Counterpart of `scenedreamer_tpu/utils/io.py` (reference
`imaginaire/utils/io.py`). Images are written as PNG by
`utils/png.py:write_png`, so no image library is needed;
`get_checkpoint` resolves local paths only and raises for a URL, as the
JAX package's does (nothing here downloads).
"""
import os


def save_image(path, img_uint8_rgb):
    """uint8 HWC RGB (or HW gray) -> a PNG file at `path`, creating its
    directory."""
    from scenedreamer_tpu_torch.utils.png import write_png
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    write_png(path, img_uint8_rgb)


def save_tensor_image(path, img):
    """[-1, 1] float HWC image (or the first of an NHWC batch; numpy or a
    tensor) -> a PNG file."""
    from scenedreamer_tpu_torch.utils.visualization import _host, tensor2im
    img = _host(img)
    if img.ndim == 4:
        img = img[0]
    save_image(path, tensor2im(img))


def get_checkpoint(path_or_url, checkpoint_dir='checkpoints'):
    """Resolve a checkpoint path (reference `utils/io.py get_checkpoint`).

    A local path is returned as it is. A URL resolves to the file of its
    name in `checkpoint_dir` when that exists, and raises otherwise:
    fetch the file yourself and pass the local path."""
    if path_or_url.startswith(('http://', 'https://', 'gs://')):
        local = os.path.join(checkpoint_dir, os.path.basename(path_or_url))
        if os.path.exists(local):
            return local
        raise FileNotFoundError(
            f'{path_or_url} is remote and nothing is downloaded here; '
            f'place the file at {local} instead')
    if not os.path.exists(path_or_url):
        raise FileNotFoundError(path_or_url)
    return path_or_url
