"""The port's multi-process training on the CPU: two gloo ranks
(`tests/_torch_dist_worker.py`, subprocesses that import no JAX) against
the JAX package's shard_map data-parallel step on a 2-device CPU mesh
(`make_mesh(data=2, rays=1)`), and against the port's own one-process
steps.

Data parallel: the TINY generator of `tests/test_train.py` with
deterministic depth sampling, D with 8 filters, the VGG loss at
relu_2_1, a batch of 2; rank i takes item i and JAX's group-i style
draws (the reparameterisation eps of `fold_in(key, i)`). The JAX
table-gradient payloads are patched to float32, as in
`test_torch_train.py`, whose tolerances hold here: losses 1e-5 relative,
gradient norms 1e-4, the KL term 1e-6 absolute besides; parameters 1e-6
absolute where the port's gradient has |g| >= 1e-5, else within 2 lr
(Adam with beta1 = 0 turns float32 noise in a near-zero gradient into a
step of +-lr) and such elements fewer than 1%; the spectral-norm vectors
1e-6.

The paired hash variant: the two ranks against one process's batch-2
step with the same draws and half the KL weight (the KL term sums over
the batch; the ranks mean their sums, as JAX's pmean and DDP do), the
same parameter tolerance; its `gen/kl` is half the process's.

Rows (data 1 x rays 2, stochastic sampling, each rank renders 17 of the
34 rows): against one process's step from the same weights and seed,
metrics 1e-6 relative, parameters as above (the GEMMs of a band run on
fewer rows and may round otherwise; measured: metrics equal, parameters
within 2.5e-7). Also the meters' cross-process mean and its raise, the
global batch check and the rays group's batch broadcast."""
import os
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scenedreamer_tpu.data.synthetic import make_batch as j_make_batch
from scenedreamer_tpu.data.synthetic import make_world
from scenedreamer_tpu.models.discriminator import \
    GANcraftDiscriminator as JDis
from scenedreamer_tpu.models.generator import SceneDreamerGenerator as JGen
from scenedreamer_tpu.ops import hashgrid as jhg
from scenedreamer_tpu.parallel import mesh as jpm
from scenedreamer_tpu.train import losses as JL
from scenedreamer_tpu.train import optim as joptim
from scenedreamer_tpu.train.trainer import GANTrainer as JTrainer
from scenedreamer_tpu.train.trainer import TrainerConfig as JConfig
from scenedreamer_tpu.train.trainer import TrainState
from scenedreamer_tpu.utils.convert import convert_scenedreamer_generator
from scenedreamer_tpu_torch.models.discriminator import GANcraftDiscriminator
from scenedreamer_tpu_torch.models.generator import (GeneratorConfig,
                                                     SceneDreamerGenerator)
from scenedreamer_tpu_torch.models.vgg import VGG19Features
from scenedreamer_tpu_torch.utils.convert import (
    discriminator_state_dict_from_flax, generator_state_dict_from_flax)
from _torch_parity import cap_torch_threads, port_config
from test_torch_train import TINY, _style_eps
from test_torch_train_amp import _flax_dis, _flax_vgg

cap_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_LBL, NF = 12, 8
LOSS_RTOL, NORM_RTOL, KL_ATOL = 1e-5, 1e-4, 1e-6
PARAM_ATOL, GRAD_MIN = 1e-6, 1e-5
RAYS_RTOL = 1e-6
RAYS_CASES = {'default': {},
              'options': dict(raw_noise_std=1.0, sky_global_avgpool=False)}


def free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return str(s.getsockname()[1])


def run_session(cmd, timeout, **kw):
    """`subprocess.run(cmd, capture_output=True, text=True)` in a session
    of its own: at the timeout the whole session is killed, torchrun's
    ranks with it (killing torchrun alone leaves them hung in a
    collective)."""
    p = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, start_new_session=True, **kw)
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        raise
    return subprocess.CompletedProcess(cmd, p.returncode, out, err)


def spawn_ranks(script, args, n=2, cwd=REPO):
    """`n` processes of `script` <rank> <n> <args...> with the repo and
    the tests on the path."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.path.join(REPO, 'tests')]))
    return [subprocess.Popen([sys.executable, script, str(r), str(n)]
                             + list(args), cwd=cwd, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True) for r in range(n)]


def wait_ranks(procs, timeout=300):
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f'rank failed ({rc}):\n{out[-3000:]}\n{err[-3000:]}'
    return outs


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """Starts the two ranks on the port's seeded weights, then runs
    JAX's data=2 steps from the same weights while they work; returns
    (JAX results, rank 0's, rank 1's)."""
    tmp = tmp_path_factory.mktemp('ranks')
    world = make_world(size=64, seed=7, n_voronoi=20, boundary_detect=4)
    batch = j_make_batch(world, batch_size=2, height=34, width=34,
                         max_samples=4, pad=TINY.pad, seed=3)
    k = jax.random.PRNGKey(3)
    kd, kg = jax.random.split(k)

    def per_group(key):
        # the style draws of JAX's data group i: `fold_in(key, i)`
        return torch.from_numpy(np.concatenate(
            [_style_eps(jax.random.fold_in(key, i), 1) for i in range(2)]))
    # the port's seeded weights, carried to flax (a flax init of these
    # models costs a minute here)
    sds = tuple(m.state_dict() for m in (
        SceneDreamerGenerator(port_config(TINY), seed=1),
        GANcraftDiscriminator(NUM_LBL, NF, seed=1),
        VGG19Features(('relu_2_1',), seed=1)))
    torch.save(dict(
        gen_cfg={f: getattr(port_config(TINY), f)
                 for f in GeneratorConfig.__dataclass_fields__
                 if f != 'dtype'},
        g_sd=sds[0], d_sd=sds[1], vgg_sd=sds[2], num_labels=NUM_LBL, nf=NF,
        dims=tuple(int(d) for d in world.dims),
        batch={n: torch.from_numpy(np.array(v)) for n, v in batch.items()},
        eps_shared=per_group(k), eps_two=(per_group(kd), per_group(kg)),
        rays_cases=RAYS_CASES), tmp / 'inputs.pt')
    procs = spawn_ranks(os.path.join(REPO, 'tests', '_torch_dist_worker.py'),
                        [free_port(), str(tmp)])
    try:
        g_params = convert_scenedreamer_generator(
            {n: v.numpy() for n, v in sds[0].items()})['params']
        d_params, d_stats = _flax_dis(sds[1])
        mesh = jpm.make_mesh(data=2, rays=1, devices=jax.devices()[:2])
        jt = JTrainer(JGen(cfg=TINY),
                      JDis(num_labels=NUM_LBL, num_filters=NF), world.dims,
                      cfg=JConfig(), perceptual=JL.PerceptualLoss(
                          params=_flax_vgg(sds[2]), layers=('relu_2_1',),
                          weights=(1.0,)), iters_per_epoch=10, mesh=mesh)
        jt.g_tx = joptim.make_generator_optimizer(g_params,
                                                  iters_per_epoch=10)
        host = TrainState(step=np.zeros((), np.int32), g_params=g_params,
                          g_opt=jt.g_tx.init(g_params), d_params=d_params,
                          d_stats=d_stats, d_opt=jt.d_tx.init(d_params))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jhg, 'SORT_PAYLOAD_DTYPE', jnp.float32)
            mp.setattr(jhg, '_SPLAT_DTYPE', jnp.float32)
            sharded = jpm.shard_batch(mesh, batch)
            out = {}
            for name, step in (('dp_shared', jt.train_step_shared),
                               ('dp_two', jt.train_step)):
                # fresh copies: the step donates its state
                s = jpm.replicate(mesh, jax.tree_util.tree_map(jnp.array,
                                                               host))
                s, m = step(s, sharded, k)
                out[name] = (jax.device_get(s),
                             {n: float(v) for n, v in m.items()})
    finally:
        wait_ranks(procs)
    ranks = [torch.load(tmp / f'rank{r}.pt', weights_only=False)
             for r in range(2)]
    return out, ranks[0], ranks[1]


def _assert_params(got, want_g, want_d):
    """Parameters and buffers of a rank's step (`got`) against state
    dicts, to PARAM_ATOL, or to 2 lr where the gradient is below
    GRAD_MIN, such elements under 1%."""
    n_loose = n_all = 0
    for part, want in (('gen', want_g), ('dis', want_d)):
        assert set(got[part]) == set(want)
        for name, w in want.items():
            err = (got[part][name] - w).abs()
            key = f'{part}.{name}'
            if key not in got['grads']:                 # spectral norm
                assert float(err.max()) <= PARAM_ATOL, key
                continue
            flat = got['grads'][key].abs() < GRAD_MIN
            bad = err > torch.where(flat, 2 * got['lrs'][key] + PARAM_ATOL,
                                    PARAM_ATOL)
            assert not bad.any(), (key, int(bad.sum()), float(err.max()))
            n_loose += int((flat & (err > PARAM_ATOL)).sum())
            n_all += err.numel()
    assert n_loose < 1e-2 * n_all, (n_loose, n_all)


def _assert_metrics(got, want):
    assert set(got) == set(want)
    for name, w in want.items():
        rtol = NORM_RTOL if name.endswith('grad_norm') else LOSS_RTOL
        atol = KL_ATOL if name == 'gen/kl' else 0.0
        np.testing.assert_allclose(got[name], w, rtol=rtol, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize('step', ['dp_shared', 'dp_two'])
def test_data_parallel_step_matches_jax_mesh(runs, step):
    jax_out, r0, _ = runs
    jstate, jm = jax_out[step]
    _assert_metrics(r0[step]['metrics'], jm)
    _assert_params(r0[step],
                   generator_state_dict_from_flax(jstate.g_params),
                   discriminator_state_dict_from_flax(jstate.d_params,
                                                      jstate.d_stats))
    assert int(jstate.step) == 1


@pytest.mark.parametrize('step', ['dp_shared', 'dp_two', 'dp_paired',
                                  'rays_default', 'rays_options'])
def test_ranks_end_with_equal_state(runs, step):
    """Every rank takes the same update: the gradients, metrics and
    spectral-norm vectors are all-reduced before the optimizer."""
    _, r0, r1 = runs
    assert r0[step]['metrics'] == r1[step]['metrics']
    for part in ('gen', 'dis'):
        for name, v in r0[step][part].items():
            assert torch.equal(v, r1[step][part][name]), (part, name)


def test_paired_data_parallel_matches_one_process(runs):
    _, r0, _ = runs
    got, want = r0['dp_paired'], r0['one_paired']
    _assert_params(got, want['gen'], want['dis'])
    gm, wm = dict(got['metrics']), dict(want['metrics'])
    np.testing.assert_allclose(gm.pop('gen/kl'), wm.pop('gen/kl') / 2,
                               rtol=LOSS_RTOL, atol=KL_ATOL)
    _assert_metrics(gm, wm)


@pytest.mark.parametrize('case', sorted(RAYS_CASES))
def test_rays_step_matches_rays_one(runs, case):
    _, r0, _ = runs
    got, want = r0[f'rays_{case}'], r0[f'one_{case}']
    for name, w in want['metrics'].items():
        np.testing.assert_allclose(got['metrics'][name], w, rtol=RAYS_RTOL,
                                   err_msg=name)
    _assert_params(got, want['gen'], want['dis'])
    assert 'compact_k' in r0['rays_compact_k']


def test_meters_mean_over_ranks_and_refuse_diverging_names(runs):
    _, r0, r1 = runs
    recs = {k: v for rec in r0['meters'] for k, v in rec.items()
            if k not in ('t', 'step')}
    # 'a': ranks wrote 1 and 2; 'b': rank 0 only (NaN on rank 1)
    assert recs == {'a': 1.5, 'b': 5.0}
    assert all(isinstance(v, float) for v in recs.values())
    for r in (r0, r1):
        assert 'meter name sets diverge' in r['meters_raise']


def test_global_batch_check_and_batch_broadcast(runs):
    _, r0, r1 = runs
    assert 'images' in r0['global_batch']
    for r in (r0, r1):
        assert "must divide the 'data' axis" in r['global_batch_raise']
        assert r['broadcast_equal']
