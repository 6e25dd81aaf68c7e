"""The squeeze-and-excitation ops (``mnasnet_tpu_torch/ops/cuda/se.py``) on the
CPU: each op's CPU impl against its plain formula, the autograd Function
against autograd of the plain module at EfficientNet-B4's first and last SE
plane shapes, the fake impls, the launch plans at B4's twelve SE shapes, and
the model's choice of route. The kernels themselves run only on the card
(``tests/test_torch_gpu.py``)."""

import pytest
import torch

from mnasnet_tpu_torch import create_model
from mnasnet_tpu_torch.models.layers import SqueezeExcitation, nchw
from mnasnet_tpu_torch.ops.cuda import se
from mnasnet_tpu_torch.tools.export_serving import build_forward, export_artifact

OPS = (se.se_pool, se.se_scale, se.se_dgate, se.se_dx)
# (H, C) of efficientnet_b4@380's 12 distinct SE planes (the dw outputs).
B4_SE = [(12, 960), (12, 1632), (12, 2688), (24, 336), (24, 672), (24, 960), (48, 192),
         (48, 336), (95, 144), (95, 192), (190, 24), (190, 48)]


def _rel(out, ref) -> float:
    out, ref = out.detach().double(), ref.detach().double()
    return float((out - ref).abs().max() / ref.abs().max())


def _case(n, h, c, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(n, h, h, c, generator=g) + 0.2).to(dtype)
    dy = torch.randn(n, h, h, c, generator=g).to(dtype)
    gate = torch.sigmoid(torch.randn(n, c, generator=g)).to(dtype)
    dpool = torch.randn(n, c, generator=g).to(dtype)
    return x, dy, gate, dpool


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_each_op_cpu_impl_is_its_plain_formula(dtype):
    """Pool: the mean over H and W in x's dtype; scale: x·gate in x's dtype;
    gate gradient: Σ_hw g·x in fp32 (float64 stays); dx: g·gate + dpool/HW
    rounded once to g's dtype. No launch is counted on the CPU."""
    x, dy, gate, dpool = _case(3, 7, 16, dtype)
    before = [op.launches for op in OPS]
    pool, y = se.se_pool(x), se.se_scale(x, gate)
    dgate, dx = se.se_dgate(dy, x), se.se_dx(dy, gate, dpool)
    assert [op.launches for op in OPS] == before
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    x64, dy64 = x.double(), dy.double()
    assert pool.dtype == dtype and pool.shape == (3, 16)
    one = {torch.float32: 2e-7, torch.bfloat16: 2.0 ** -8, torch.float64: 1e-15}[dtype]
    assert _rel(pool, x64.sum(dim=(1, 2)) / 49) <= one
    assert y.dtype == dtype and y.is_contiguous()
    assert torch.equal(y, x * gate[:, None, None, :])
    assert dgate.dtype == acc and dgate.shape == (3, 16)
    assert _rel(dgate, torch.einsum("nhwc,nhwc->nc", dy64, x64)) <= 1e-6
    ref = dy64 * gate.double()[:, None, None, :] + dpool.double()[:, None, None, :] / 49
    assert dx.dtype == dtype and dx.is_contiguous() and _rel(dx, ref) <= one


def test_ops_check_their_inputs():
    x, dy, gate, dpool = _case(2, 5, 8, torch.float32)
    with pytest.raises(ValueError, match="NHWC"):
        se.se_pool(x[0])
    with pytest.raises(ValueError, match="vectors"):
        se.se_scale(x, gate[:, :4])
    with pytest.raises(ValueError, match="planes"):
        se.se_dgate(dy[:1], x)
    with pytest.raises(RuntimeError, match="autograd"):
        se.se_scale(x, gate.requires_grad_())


def _module(c, squeeze, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    m = SqueezeExcitation(c, squeeze)
    with torch.no_grad():
        for fc in (m.fc1, m.fc2):
            fc.weight.copy_(torch.randn(fc.weight.shape, generator=g) / fc.weight.shape[1] ** 0.5)
            fc.bias.copy_(torch.randn(fc.bias.shape, generator=g) * 0.1)
    return m.double() if dtype == torch.float64 else m


def _run(m, x, dy, kernels):
    """y, dx and the four parameters' gradients of the module on NHWC x."""
    m.kernels = kernels
    m.zero_grad()
    xs = nchw(x).detach().clone().requires_grad_()
    y = m(xs)
    y.backward(nchw(dy))
    return [y, xs.grad, *(p.grad for p in m.parameters())]


@pytest.mark.parametrize("h,c,squeeze", [(190, 48, 12), (190, 24, 6), (12, 2688, 112)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_se_function_matches_autograd_of_the_plain_module(h, c, squeeze, dtype):
    """The module on the SE ops (the autograd Function) against autograd of
    its plain forward, at B4's first-stage planes (190x190, 48 and 24
    channels) and its last (12x12, 2688 channels), batch 2: in fp32 y, dx
    and the four parameters' gradients to a few roundings of the plain
    module's; in bf16 each within 2^-6 of the largest value of float64
    autograd's (the MLP in bf16, as the plain module's), as the plain
    module's own bf16 autograd is."""
    x, dy, _, _ = _case(2, h, c, dtype, seed=h + c)
    m = _module(c, squeeze, dtype, seed=c)
    ours = _run(m, x, dy, True)
    plain = _run(m, x, dy, False)
    assert ours[0].is_contiguous(memory_format=torch.channels_last)
    assert ours[0].dtype == dtype and ours[1].dtype == dtype
    if dtype == torch.float32:
        for a, b in zip(ours, plain):
            assert _rel(a, b) <= 1e-6
        return
    exact = _run(_module(c, squeeze, torch.float64, seed=c), x.double(), dy.double(), False)
    for a, b, e in zip(ours, plain, exact):
        assert _rel(b, e) <= 2.0 ** -6 and _rel(a, e) <= 2.0 ** -6


def test_se_function_without_grad_is_the_ops_alone():
    """Where autograd records nothing (an export, eval under no_grad) the
    module's op route is the same forward, with no Function in it."""
    x, _, _, _ = _case(2, 9, 32, torch.float32)
    m = _module(32, 8, torch.float32, seed=3)
    m.kernels = True
    with torch.no_grad():
        y = m(nchw(x))
    assert y.grad_fn is None
    assert torch.equal(y, _run(m, x, torch.zeros_like(x), True)[0].detach())


def test_fake_impls_give_the_outputs_shapes():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x = torch.empty(4, 6, 6, 40, dtype=torch.bfloat16)
        gate = torch.empty(4, 40, dtype=torch.bfloat16)
        ops = torch.ops.mnasnet_tpu_torch
        pool, y = ops.se_pool.default(x), ops.se_scale.default(x, gate)
        dgate, dx = ops.se_dgate.default(x, x), ops.se_dx.default(x, gate, gate)
    assert (pool.shape, pool.dtype) == ((4, 40), torch.bfloat16)
    assert (dgate.shape, dgate.dtype) == ((4, 40), torch.float32)
    assert y.shape == dx.shape == x.shape and y.dtype == dx.dtype == torch.bfloat16


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("h,c", B4_SE)
def test_plans_cover_the_b4_shapes(h, c, itemsize):
    """At each of B4's SE planes, batch 64: the reduction's tiles cover the
    channels with less than a tile over, its slabs the rows with none
    empty, at most 64 of them, and at least 2 blocks an SM of an H100; the
    elementwise pass's tiles split the row's vectors evenly with at most a
    sixteenth of a block idle."""
    n, hw = 64, h * h
    p = se.reduce_plan(n, hw, c, itemsize)
    assert p.vec_bytes == 16 and p.vec * itemsize == 16
    assert (p.tiles - 1) * p.tg * p.vec < c <= p.tiles * p.tg * p.vec
    assert p.lanes * p.tg <= se.THREADS and p.slabs <= se.MAX_SLABS
    assert (p.slabs - 1) * p.rows_per_slab < hw <= p.slabs * p.rows_per_slab
    assert n * p.tiles * p.slabs >= 2 * 132
    assert (p.partial_floats, p.tickets) == ((n * p.tiles * p.slabs * p.tg * p.vec, n * p.tiles)
                                             if p.slabs > 1 else (0, 0))
    q = se.map_plan(n, hw, c, itemsize)
    assert q.tiles * q.tg * q.vec == c and 16 * q.lanes * q.tg >= 15 * se.THREADS
    assert (q.slabs - 1) * q.rows_per_slab < hw <= q.slabs * q.rows_per_slab
    assert n * q.tiles * q.slabs >= 2 * 132


def test_plans_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="even channel count"):
        se.reduce_plan(2, 9, 7, 2)
    with pytest.raises(ValueError, match="aligned"):
        se.map_plan(2, 9, 8, 2, align=2)
    with pytest.raises(ValueError, match="65535"):
        se.map_plan(70000, 9, 8, 2)
    assert se.map_plan(2, 9, 12, 2).vec_bytes == 8


def _b0(**kw):
    return create_model("efficientnet_b0", device="cpu", num_classes=10, width_mult=0.25,
                        depth_mult=0.3, **kw)


@pytest.mark.parametrize("training,knob,kernels", [
    (True, {"bn_bwd": "kernel"}, True), (True, {"bn_bwd": "torch"}, False),
    (True, {"bn_bwd": "auto"}, False), (False, {"dw_impl": "kernel"}, True),
    (False, {"dw_impl": "taps"}, True), (False, {"dw_impl": "torch"}, False)])
def test_each_block_takes_the_se_ops_where_it_takes_its_kernels(training, knob, kernels):
    """In train mode SE takes the ops where the BN regions take theirs (the
    ``bn_bwd`` route resolves to the kernels: on a CUDA tensor for
    ``auto``), in eval on every dw route but ``torch``; a CPU tensor takes
    the ops' CPU impls."""
    model = _b0(**knob).train(training)
    with torch.set_grad_enabled(training):
        model(torch.randn(2, 3, 32, 32))
    flags = {m.kernels for m in model.modules() if isinstance(m, SqueezeExcitation)}
    assert flags == {kernels}


def test_the_export_records_the_se_ops(tmp_path):
    """The eval forward's artifact holds the pool and scale ops, one each a
    block, and no backward op."""
    fn, x = build_forward("efficientnet_b0", 10, "float32", None, 32, 2, device="cpu")
    program = torch.export.load(__import__("io").BytesIO(export_artifact(fn, x)))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    blocks = sum(isinstance(m, SqueezeExcitation) for m in fn.modules())
    assert targets.count("mnasnet_tpu_torch.se_pool.default") == blocks == 16
    assert targets.count("mnasnet_tpu_torch.se_scale.default") == blocks
    assert not any("se_dgate" in t or "se_dx" in t for t in targets)
