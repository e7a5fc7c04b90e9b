"""Interactive demo CLI.

Counterpart of `scenedreamer_tpu/cli/demo.py` (reference
`app_gradio.py:69-136`) on the port: a seed gives the BEV maps
(`get_bev`) and a rendered fly-through video (`get_video`). With the
`gradio` package installed, `--serve` runs a web UI; without it,
`--serve` exits with a message and the default is headless: both actions
run and write their outputs to `--output_dir`. Runs on CUDA; `--device
cpu` runs the plain PyTorch path.

Usage:
    python -m scenedreamer_tpu_torch.cli.demo --output_dir demo_out --seed 8888
    python -m scenedreamer_tpu_torch.cli.demo --serve        # needs gradio
"""
import argparse
import os


def get_bev(seed, scene_size=1024):
    """seed -> (height visualization, semantic visualization), and the
    built world (reference `app_gradio.py:69-77`)."""
    import numpy as np
    from scenedreamer_tpu_torch.render.pipeline import BIOME_COLORS
    from scenedreamer_tpu_torch.scene.terrain import generate_terrain
    from scenedreamer_tpu_torch.scene.voxel_world import build_voxel_world
    maps = generate_terrain(size=scene_size, seed=seed)
    world = build_voxel_world(maps.height_map, maps.semantic_map,
                              maps.tree_map, fill_depth=16, seed=seed)
    hvis = np.repeat((np.clip(world.height_field[0, 0], 0, 1)
                      * 255).astype(np.uint8)[..., None], 3, -1)
    svis = BIOME_COLORS[np.argmax(world.semantic_field[0], axis=0)]
    return hvis, svis, world


def get_video(world, checkpoint, output_dir, seed, camera_mode=4,
              cam_maxstep=40, resolution=(540, 960), num_samples=40,
              tile_size=128, pad=30, device=None):
    """world + style seed -> mp4 path (reference `app_gradio.py:78-96`)."""
    import torch
    from scenedreamer_tpu_torch.cli.inference import load_generator
    from scenedreamer_tpu_torch.device import resolve_device
    from scenedreamer_tpu_torch.models.generator import GeneratorConfig
    from scenedreamer_tpu_torch.render.pipeline import render_trajectory
    device = resolve_device(device)
    cfg = GeneratorConfig(num_samples=num_samples)
    model = load_generator(checkpoint, cfg, device, seed=seed)
    style = torch.randn((1, cfg.style_dims),
                        generator=torch.Generator().manual_seed(seed))
    render_trajectory(model, world, style.numpy(), output_dir,
                      camera_mode=camera_mode, cam_maxstep=cam_maxstep,
                      num_samples=num_samples, pad=pad, tile_size=tile_size,
                      resolution_hw=resolution, seed=seed, device=device)
    return os.path.join(output_dir, 'rgb_render.mp4')


def serve(args):
    import gradio as gr

    state = {}

    def on_bev(seed):
        hvis, svis, world = get_bev(int(seed), args.scene_size)
        state['world'] = world
        return hvis, svis

    def on_video(seed):
        return get_video(state['world'], args.checkpoint, args.output_dir,
                         int(seed), resolution=tuple(args.resolution),
                         device=args.device)

    with gr.Blocks(title='SceneDreamer') as demo:
        seed = gr.Number(value=8888, label='seed')
        btn_bev = gr.Button('Generate BEV')
        h_img = gr.Image(label='height map')
        s_img = gr.Image(label='semantic map')
        btn_vid = gr.Button('Render fly-through')
        vid = gr.Video(label='render')
        btn_bev.click(on_bev, [seed], [h_img, s_img])
        btn_vid.click(on_video, [seed], [vid])
    demo.launch()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--output_dir', default='demo_out')
    p.add_argument('--checkpoint', default='')
    p.add_argument('--seed', type=int, default=8888)
    p.add_argument('--scene_size', type=int, default=1024)
    p.add_argument('--resolution', type=int, nargs=2, default=[540, 960])
    p.add_argument('--camera_mode', type=int, default=4)
    p.add_argument('--cam_maxstep', type=int, default=40)
    p.add_argument('--num_samples', type=int, default=40)
    p.add_argument('--serve', action='store_true',
                   help='launch the gradio web UI (requires gradio)')
    p.add_argument('--device', default=None,
                   help="torch device (default 'cuda'; 'cpu' runs the "
                        'plain PyTorch path)')
    a = p.parse_args(argv)
    from scenedreamer_tpu_torch.device import resolve_device
    a.device = resolve_device(a.device)

    if a.serve:
        try:
            import gradio  # noqa: F401
        except ImportError:
            raise SystemExit('gradio is not installed; run without --serve '
                             'for the headless demo')
        serve(a)
        return

    from scenedreamer_tpu_torch.utils.png import write_png
    os.makedirs(a.output_dir, exist_ok=True)
    hvis, svis, world = get_bev(a.seed, a.scene_size)
    write_png(os.path.join(a.output_dir, 'bev_height.png'), hvis)
    write_png(os.path.join(a.output_dir, 'bev_semantic.png'), svis)
    print(f'[demo] BEV maps -> {a.output_dir}')
    path = get_video(world, a.checkpoint, a.output_dir, a.seed,
                     camera_mode=a.camera_mode, cam_maxstep=a.cam_maxstep,
                     resolution=tuple(a.resolution),
                     num_samples=a.num_samples, device=a.device)
    print(f'[demo] video -> {path}')
    return path


if __name__ == '__main__':
    main()
