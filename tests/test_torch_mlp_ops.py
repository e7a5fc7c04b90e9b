"""The RenderMLP's hidden layers through `sd::render_mlp_gemm`
(`ops/mlp_ops.py`) on the CPU, where the op runs its plain composition:
the route autograd records nothing on gives the grad-mode forward's
numbers bit for bit, and the op's fake gives its output's shape and
dtype (what `torch.export` traces; `tests/test_torch_export.py` holds
the exported programs). The kernel itself is held in
`tests/test_torch_cuda.py`."""
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from scenedreamer_tpu_torch.models.layers import RenderMLP
from scenedreamer_tpu_torch.ops import mlp_ops


def _mlp(use_seg, viewdir_dim=0, dtype=torch.float32):
    mlp = RenderMLP(40, 16, 12, 8, hidden_channels=32,
                    viewdir_dim=viewdir_dim, use_seg=use_seg, dtype=dtype)
    gen = torch.Generator().manual_seed(1)
    for mod in mlp.modules():
        if mod is not mlp and hasattr(mod, 'reset_parameters'):
            mod.reset_parameters(gen)
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((2, 50, 40), generator=gen)
    z = torch.randn((2, 16), generator=gen)
    m = torch.nn.functional.one_hot(
        torch.randint(0, 12, (2, 50), generator=gen), 12).float()
    rd = torch.randn((2, 50, viewdir_dim), generator=gen) \
        if viewdir_dim else None
    return mlp, (x, z, m, rd)


@pytest.fixture
def op_calls(monkeypatch):
    calls = []
    op = mlp_ops.render_mlp_gemm

    def counted(*args):
        calls.append(args)
        return op(*args)
    monkeypatch.setattr(mlp_ops, 'render_mlp_gemm', counted)
    return calls


@pytest.mark.parametrize('use_seg,viewdir_dim,route', [
    (True, 0, 'no_grad'), (False, 0, 'no_grad'), (True, 0, 'frozen'),
    (True, 9, 'no_grad')])
def test_no_grad_forward_equals_grad_forward(op_calls, use_seg, viewdir_dim,
                                             route):
    """Grad off, or every parameter and input frozen: each hidden layer
    is one op call (not a view-direction `fc_5`), and sigma and the
    feature equal the grad-mode forward's bit for bit."""
    mlp, args = _mlp(use_seg, viewdir_dim)
    want = mlp(*args)
    assert not op_calls and want[1].requires_grad
    if route == 'no_grad':
        with torch.no_grad():
            got = mlp(*args)
    else:
        mlp.requires_grad_(False)
        got = mlp(*args)
    assert len(op_calls) == (5 if viewdir_dim else 6)
    assert (len(op_calls[0]) == 5) == use_seg     # the label term
    for g, w in zip(got, want):
        assert not g.requires_grad
        assert torch.equal(g, w)


def test_bf16_forward_keeps_its_ops(op_calls):
    mlp, args = _mlp(True, dtype=torch.bfloat16)
    with torch.no_grad():
        mlp(*args)
    assert not op_calls


@pytest.mark.parametrize('shared,label', [(True, True), (False, False)])
def test_fake_gives_shape_and_dtype(shared, label):
    with FakeTensorMode():
        x = torch.empty((2, 7, 5))
        w = torch.empty((3, 5) if shared else (2, 3, 5))
        shift = torch.empty((3,) if shared else (2, 3))
        extra = (torch.empty((2, 7, 12)), torch.empty((3, 12))) \
            if label else ()
        y = mlp_ops.render_mlp_gemm(x, w, shift, *extra)
        assert y.shape == (2, 7, 3) and y.dtype == torch.float32
