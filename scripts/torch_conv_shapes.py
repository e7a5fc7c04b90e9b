"""Float32 3x3 convs around `UpRes2dBlock`'s slow one, on the GPU.

    python scripts/torch_conv_shapes.py

`chip_smoke.py` phase 17 times `UpRes2dBlock` (256 -> 128 channels at
64x64, batch 2, blur upsampling) far above its neighbours; its 3x3 conv
256 -> 128 on the upsampled 2x256x128x128 map is the whole of it. This
times `F.conv2d` (padding 1, CUDA events, `chip_smoke.median_ms`) on
that shape and on its neighbours (one width or the size changed), with
TF32 off as in `chip_smoke.py`; then that shape with
`cudnn.benchmark`, in channels-last, with cuDNN disabled (PyTorch's own
conv) and with TF32 on; and names the kernels of one call
(`torch.profiler`: the kernel that takes most of the device time and
the number of launches). Needs CUDA.
"""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (batch, in, out, size): the slow shape first, then its neighbours
SHAPES = ((2, 256, 128, 128), (2, 256, 256, 128), (2, 128, 128, 128),
          (2, 256, 64, 128), (2, 256, 128, 64), (2, 256, 128, 96),
          (1, 256, 128, 128))


def main():
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print('torch_conv_shapes: CUDA is not available', file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    cs.float32_exact(torch)
    g = torch.Generator(device='cuda').manual_seed(cs.SEED)

    def conv_case(n, cin, cout, hw):
        x = torch.randn((n, cin, hw, hw), generator=g, device='cuda')
        w = torch.randn((cout, cin, 3, 3), generator=g, device='cuda')
        return x, w / (3.0 * cin ** 0.5)

    for n, cin, cout, hw in SHAPES:
        x, w = conv_case(n, cin, cout, hw)
        ms = cs.median_ms(lambda: F.conv2d(x, w, padding=1))
        gflop = 2.0 * n * hw * hw * cout * cin * 9 / 1e9
        print(f'[conv] {n}x{cin}x{hw}x{hw} -> {cout}: {ms:.3f} ms '
              f'({gflop:.2f} GFLOP, {gflop / ms:.1f} TFLOP/s)', flush=True)
    x, w = conv_case(*SHAPES[0])

    def run():
        F.conv2d(x, w, padding=1)

    torch.backends.cudnn.benchmark = True
    print(f'[conv] slow shape, cudnn.benchmark: {cs.median_ms(run):.3f} ms')
    torch.backends.cudnn.benchmark = False
    xl = x.to(memory_format=torch.channels_last)
    wl = w.to(memory_format=torch.channels_last)
    print(f'[conv] slow shape, channels-last: '
          f'{cs.median_ms(lambda: F.conv2d(xl, wl, padding=1)):.3f} ms')
    torch.backends.cudnn.enabled = False
    print(f'[conv] slow shape, cuDNN disabled: {cs.median_ms(run):.3f} ms')
    torch.backends.cudnn.enabled = True
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_time_total > 0]
    top = max(kernels, key=lambda e: e.device_time_total)
    print(f'[conv] slow shape, kernels: {sum(e.count for e in kernels)} '
          f'launches; most time {top.key[:60]} x{top.count}, '
          f'{top.device_time_total / 1e3:.1f} ms')
    torch.backends.cudnn.allow_tf32 = True
    print(f'[conv] slow shape, TF32 on: {cs.median_ms(run):.3f} ms')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == '__main__':
    sys.exit(main())
