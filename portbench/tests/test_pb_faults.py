"""The check catches a broken program: each tiny cell runs its whole
harness on the CPU (the look for a chip skipped) with a fault planted in
the program underneath, and `correct` comes out false; without a fault
it comes out true. On the card, the control (the reference in TF32) at a
small size must fail the limits too."""
import os

import pytest

import pb_support as S


@pytest.mark.parametrize('workload,fault', [('tiny.serve', 'answer'),
                                            ('tiny.step', 'frozen'),
                                            ('tiny.step', 'late_update')])
def test_fault_in_one_process_is_not_correct(tmp_path, workload, fault):
    code, line, err = S.run_tiny(str(tmp_path), workload, fault=fault)
    assert code == 0, err
    assert line['correct'] is False, line['checks']


@pytest.mark.parametrize('fault', [None, 'no_exchange', 'half_batch',
                                   'frozen'])
def test_data_parallel_fault_is_not_correct(tmp_path, fault):
    codes, line = S.run_tiny_ranks(str(tmp_path), 'tiny.dp', world=2,
                                   fault=fault)
    assert codes == [0, 0]
    assert line['correct'] is (fault is None), line['checks']


def test_banned_module_on_another_rank_refuses(tmp_path):
    codes, line = S.run_tiny_ranks(str(tmp_path), 'tiny.dp', world=2,
                                   fault='banned')
    assert codes == [2, 2]
    assert line is None


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU: the control computes in TF32, which '
                    'only the card has')


@pytest.mark.parametrize('workload', ['tiny.serve', 'tiny.step'])
def test_control_in_tf32_is_not_correct(cuda, tmp_path, workload):
    import argparse
    from portbench import control
    from portbench.run import Run
    bench = S.tiny_bench(str(tmp_path))
    for seed in (11, 12, 13):
        args = argparse.Namespace(workload=workload, seed=seed, seconds=0,
                                  trace=0)
        run = Run(bench, args, 'cuda',
                  world_cache=os.path.join(str(tmp_path), 'worlds'))
        fn = control.serve_control if workload == 'tiny.serve' \
            else control.train_control
        checks = fn(run)
        assert not all(v <= lim for _, v, lim in checks), checks
