"""Evaluation camera trajectories and random training poses.

Copy of `EvalCameraController` and the random training-pose samplers
(`neighbor_height`, `rand_camera_pose_{birdseye, firstperson,
thirdperson, thirdperson2, thirdperson3, tour, insideout}`) from
`scenedreamer_tpu/scene/camera.py` (reference `camctl.py:9-331` and
`camctl.py:445-679`): 10 deterministic fly-through patterns with
terrain-height clearance and asymmetric decay smoothing, and samplers
that are deterministic given the passed `numpy.random.Generator`.

Host-side numpy; coordinates are [y, x, z] with y up, poses are in the
world's local (vertically cropped) frame as (ori, dir, up, f) with f a
fraction of the image width.
"""
import numpy as np

_UP = np.array([1.0, 0.0, 0.0], np.float32)


def _fov_focal(deg):
    """Focal length (as a fraction of image width) for a horizontal FOV."""
    return 0.5 / np.tan(np.deg2rad(deg) / 2.0)


def neighbor_height(heightmap, x, z, minheight, neighbor_size=7):
    """Max terrain height in a (k x k) window around (x, z), floored at
    `minheight` (+2 clearance, reference `camctl.py:476-486`)."""
    k = neighbor_size // 2
    x, z = int(x), int(z)
    x0, x1 = max(0, x - k), min(heightmap.shape[0], x + k + 1)
    z0, z1 = max(0, z - k), min(heightmap.shape[1], z + k + 1)
    if x0 >= x1 or z0 >= z1:
        return float(minheight)
    window_max = float(heightmap[x0:x1, z0:z1].max()) + 2.0
    return max(float(minheight), window_max)


def _pose(world, farpoint, nearpoint, up=None):
    ori = world.world2local(np.asarray(farpoint, np.float32))
    direc = np.asarray(nearpoint, np.float32) - np.asarray(farpoint,
                                                           np.float32)
    up = _UP if up is None else np.asarray(up, np.float32)
    return ori, direc, up


def _decay_smooth(vals, decay):
    """Forward+backward pass of the reference's asymmetric peak-hold
    filter (`camctl.py:309-325`): heights may drop at most `decay`/step."""
    out = list(vals)
    prev = vals[0]
    for i in range(len(vals)):
        prev = max(prev - decay, vals[i])
        out[i] = prev
    prev = vals[-1]
    for i in range(len(vals) - 1, -1, -1):
        prev = max(prev - decay, vals[i])
        out[i] = max(out[i], prev)
    return out


class EvalCameraController:
    """Deterministic fly-through trajectories, patterns 0-9.

    Pattern summary (reference `camctl.py:20-293`): 0 orbit, 1 orbit+zoom,
    2/3/4 spiral variants, 5 look-outward orbit, 6 rise, 7 45-degree
    overview, 8/9 sliding straight-line passes.
    """

    def __init__(self, world, maxstep=128, pattern=0, cam_ang=73,
                 smooth_decay_multiplier=1.0):
        self.world = world
        hm = world.heightmap
        sy, sx = world.voxel.shape[1], world.voxel.shape[2]
        circle = np.linspace(0, 2 * np.pi, maxstep)
        size = min(sy, sx) / 2.0
        shift = size * 0.2
        size = size * 0.8
        cy, cz = sy / 2.0 + shift, sx / 2.0 + shift
        decay = 0.2 * smooth_decay_multiplier
        poses = []

        def clearance(p, minh):
            h = minh
            for dx in range(-3, 4):
                for dz in range(-3, 4):
                    xx, zz = int(p[1]) + dx, int(p[2]) + dz
                    if 0 <= xx < hm.shape[0] and 0 <= zz < hm.shape[1]:
                        h = max(h, float(hm[xx, zz]) + 2.0)
            return h

        def orbit_xy(ang, radius):
            return np.sin(ang) * radius + cy, np.cos(ang) * radius + cz

        def add(far, near, f):
            ori, direc, up = _pose(self.world, far, near)
            poses.append((ori, direc, up, f))

        base_f = _fov_focal(cam_ang)

        if pattern in (0, 1, 2, 3, 4):
            far_h = {0: 70, 1: 90, 2: 90, 3: 70, 4: 90}[pattern]
            move = {0: np.ones(maxstep),
                    1: np.ones(maxstep),
                    2: np.linspace(1.0, 0.2, maxstep),
                    3: np.linspace(0.75, 0.2, maxstep),
                    4: np.linspace(1.0, 0.5, maxstep)}[pattern]
            sgn = -1.0 if pattern == 3 else 1.0
            near_off = {0: 0.5 * np.pi, 1: -0.3 * np.pi, 2: 0.5 * np.pi,
                        3: -0.4 * np.pi, 4: 0.5 * np.pi}[pattern]
            near_rad = {0: 0.5, 1: 0.3, 2: 0.3, 3: 0.9, 4: 0.3}[pattern]
            zoom = np.linspace(1.0, 0.25, maxstep) if pattern == 1 \
                else np.ones(maxstep)
            heights = []
            for i in range(maxstep):
                fy, fz = orbit_xy(sgn * circle[i], size * move[i])
                heights.append(clearance((far_h, fy, fz), far_h))
            heights = _decay_smooth(heights, decay)
            for i in range(maxstep):
                fy, fz = orbit_xy(sgn * circle[i], size * move[i])
                far = np.array([heights[i], fy, fz], np.float32)
                ny, nz2 = orbit_xy(sgn * circle[i] + near_off,
                                   size * near_rad * move[i])
                near = np.array([60.0, ny, nz2], np.float32)
                f = _fov_focal(cam_ang * zoom[i]) if pattern == 1 else base_f
                add(far, near, f)
        elif pattern == 5:
            move = np.linspace(1.0, 0.5, maxstep)
            heights = []
            for i in range(maxstep):
                ny, nz2 = orbit_xy(circle[i] + 0.5 * np.pi,
                                   size * 0.3 * move[i])
                heights.append(clearance((60, ny, nz2), 60))
            heights = _decay_smooth(heights, decay)
            for i in range(maxstep):
                ny, nz2 = orbit_xy(circle[i] + 0.5 * np.pi,
                                   size * 0.3 * move[i])
                near = np.array([heights[i], ny, nz2], np.float32)
                fy, fz = orbit_xy(circle[i], size * move[i])
                far = np.array([60.0, fy, fz], np.float32)
                add(near, far, base_f)     # looking outward: ori at near
        elif pattern == 6:
            lift = np.linspace(0.0, 200.0, maxstep)
            zoom = np.linspace(0.8, 1.6, maxstep)
            cy0, cz0 = sy / 2.0, sx / 2.0
            for i in range(maxstep):
                fy = np.sin(circle[i] / 4) * size * 0.2 + cy0
                fz = np.cos(circle[i] / 4) * size * 0.2 + cz0
                far = np.array([clearance((80 + lift[i], fy, fz),
                                          80 + lift[i]), fy, fz], np.float32)
                ny = np.sin(circle[i] / 4 + 0.5 * np.pi) * size * 0.1 + cy0
                nz2 = np.cos(circle[i] / 4 + 0.5 * np.pi) * size * 0.1 + cz0
                near = np.array([65.0, ny, nz2], np.float32)
                add(far, near, _fov_focal(73 * zoom[i]))
        elif pattern == 7:
            rad = np.deg2rad(45.0)
            dist = 1536.0
            for _ in range(maxstep):
                far = np.array([61 + dist, np.sin(rad) * dist + sy / 2.0,
                                np.cos(rad) * dist + sx / 2.0], np.float32)
                near = np.array([61.0, sy / 2.0, sx / 2.0], np.float32)
                add(far, near, _fov_focal(19.5))
        elif pattern == 8:
            half = sy // 2
            for i in range(maxstep):
                slide = sx / 2.0 + half // maxstep * (i - maxstep // 4)
                far = np.array([300.0, sy // 2, -half + slide], np.float32)
                near = np.array([120.0, sy // 2, -half * 0.5 + slide],
                                np.float32)
                add(far, near, base_f)
        elif pattern == 9:
            half = sx // 2
            for i in range(maxstep):
                far = np.array([140.0, sy // 2,
                                -half // 4 + half * 8 // maxstep * i],
                               np.float32)
                near = np.array([100.0, sy // 2, half * 8 // maxstep * i],
                                np.float32)
                add(far, near, base_f)
        else:
            raise ValueError(f'unknown camera pattern {pattern}')
        self.camera_poses = poses

    def __len__(self):
        return len(self.camera_poses)

    def __getitem__(self, i):
        return self.camera_poses[i]

    def __iter__(self):
        return iter(self.camera_poses)


class TourCameraController:
    """Four-phase tour: orbit -> orbit+zoom -> spiral-in -> rise
    (reference `camctl.py:334-442`): `maxstep // 4` poses each of
    `EvalCameraController` patterns 0, 1, 2 and 6 at 73 degrees."""

    def __init__(self, world, maxstep=128):
        q = maxstep // 4
        self.camera_poses = []
        for pattern in (0, 1, 2, 6):
            ctl = EvalCameraController(world, maxstep=q, pattern=pattern,
                                       cam_ang=73)
            self.camera_poses.extend(ctl.camera_poses)

    def __len__(self):
        return len(self.camera_poses)

    def __getitem__(self, i):
        return self.camera_poses[i]

    def __iter__(self):
        return iter(self.camera_poses)


# --------------------------------------------------------------------------
# Random training-pose samplers
# --------------------------------------------------------------------------

def _tilted_up(rng):
    up = rng.standard_normal(3).astype(np.float32) * 0.02
    up[0] = 1.0
    return up / np.linalg.norm(up)


def rand_camera_pose_birdseye(world, rng, border=128):
    """Upper-hemisphere direction looking at a random terrain point."""
    d = rng.standard_normal(3).astype(np.float32)
    d /= np.linalg.norm(d)
    d[0] = -abs(d[0])
    sy, sx = world.heightmap.shape
    r0 = rng.random() * (sy - 2 * border) + border
    r1 = rng.random() * (sx - 2 * border) + border
    y = world.heightmap[int(r0 + 0.5), int(r1 + 0.5)] \
        + (rng.random() - 0.5) * 5
    target = np.array([y, r0, r1], np.float32)
    ori = target - d * (rng.random() * 100)
    ori[0] = max(neighbor_height(world.heightmap, ori[1], ori[2], 0,
                                 neighbor_size=1), ori[0])
    return world.world2local(ori), d, _UP.copy()


def rand_camera_pose_firstperson(world, rng, border=128):
    sy, sx = world.heightmap.shape
    r = rng.random(5)
    p0 = r[0] * (sy - 2 * border) + border
    p1 = r[1] * (sx - 2 * border) + border
    y = neighbor_height(world.heightmap, p0, p1, 0) + rng.random() * 15
    ori = np.array([y, p0, p1], np.float32)
    ang = r[2] * 2 * np.pi
    target = np.array([0.0, ori[1] + np.sin(ang) * border * r[4],
                       ori[2] + np.cos(ang) * border * r[4]], np.float32)
    target[0] = neighbor_height(world.heightmap, target[1], target[2], 0,
                                neighbor_size=1) - 2 + r[3] * 10
    return world.world2local(ori), target - ori, _UP.copy()


def _rand_far_near(world, rng, border, far_h_lo=60.0, far_h_rand=40.0,
                   far_neighbor=5, near_neighbor=1):
    sy, sx = world.heightmap.shape
    r = rng.random(2)
    fx = r[0] * (sy - 2 * border) + border
    fz = r[1] * (sx - 2 * border) + border
    fh = far_h_lo + rng.random() * far_h_rand
    fh = neighbor_height(world.heightmap, fx, fz, fh,
                         neighbor_size=far_neighbor)
    far = np.array([fh, fx, fz], np.float32)
    r = rng.random(2)
    nx = r[0] * (sy - 2 * border) + border
    nz = r[1] * (sx - 2 * border) + border
    nh = neighbor_height(world.heightmap, nx, nz, 65,
                         neighbor_size=near_neighbor) - 5
    near = np.array([nh, nx, nz], np.float32)
    return far, near


def rand_camera_pose_thirdperson(world, rng, border=96):
    far, near = _rand_far_near(world, rng, border)
    ori, direc, up = _pose(world, far, near)
    return ori, direc, up


def rand_camera_pose_thirdperson2(world, rng, border=48):
    far, near = _rand_far_near(world, rng, border)
    ori, direc, _ = _pose(world, far, near)
    return ori, direc, _tilted_up(rng)


def rand_camera_pose_thirdperson3(world, rng, border=64):
    """Occasional higher aerial poses; wider clearance windows."""
    fh_rand = 60.0 if rng.random() > 0.8 else 40.0
    far, near = _rand_far_near(world, rng, border, far_h_rand=fh_rand,
                               far_neighbor=7, near_neighbor=3)
    ori, direc, _ = _pose(world, far, near)
    return ori, direc, _tilted_up(rng)


def rand_camera_pose_tour(world, rng):
    """Orbit-style pose pair around the scene center with random radius /
    angle / fov (reference `camctl.py:606-640`). Returns (ori, dir, up, f);
    f is a fraction of image width."""
    sy, sx = world.heightmap.shape
    size = min(sy, sx) / 2.0
    center = (sy / 2.0, sx / 2.0)
    rnd = rng.random(8)
    ang = rng.random() * 2 * np.pi
    far_radius = rnd[0] * 0.8 + 0.2
    far = np.array([rnd[1] * 30 + 60,
                    np.sin(ang) * size * far_radius + center[0],
                    np.cos(ang) * size * far_radius + center[1]], np.float32)
    far[0] = neighbor_height(world.heightmap, far[1], far[2], far[0])
    near_rad = far_radius * rnd[2]
    shift = np.pi * (rnd[3] - 0.5)
    near = np.array([60 + rnd[4] * 10,
                     np.sin(ang + shift) * size * near_rad + center[0],
                     np.cos(ang + shift) * size * near_rad + center[1]],
                    np.float32)
    ori, direc, _ = _pose(world, far, near)
    f = _fov_focal(73 * (rnd[5] * 0.75 + 0.25))
    return ori, direc, _tilted_up(rng), f


def rand_camera_pose_insideout(world, rng):
    """Looking outward from near the center (reference camctl.py:645-679)."""
    sy, sx = world.heightmap.shape
    size = min(sy, sx) / 2.0
    center = (sy / 2.0, sx / 2.0)
    rnd = rng.random(8)
    ang = rng.random() * 2 * np.pi
    far_radius = rnd[0] * 0.8 + 0.2
    far = np.array([rnd[1] * 10 + 60,
                    np.sin(ang) * size * far_radius + center[0],
                    np.cos(ang) * size * far_radius + center[1]], np.float32)
    near_rad = far_radius * rnd[2]
    shift = np.pi * (rnd[3] - 0.5)
    near = np.array([60 + rnd[4] * 30,
                     np.sin(ang + shift) * size * near_rad + center[0],
                     np.cos(ang + shift) * size * near_rad + center[1]],
                    np.float32)
    near[0] = neighbor_height(world.heightmap, near[1], near[2], near[0])
    ori = world.world2local(near)
    f = _fov_focal(73 * (rnd[5] * 0.75 + 0.25))
    return ori, far - near, _tilted_up(rng), f


