"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips (inside the test) where
``torch.cuda.is_available()`` is false. This file imports neither JAX nor the
JAX package, so it also runs on a machine with only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu
"""

import numpy as np
import pytest
import torch

from mnasnet_tpu_torch import create_model
from mnasnet_tpu_torch.models.mnasnet import InvertedResidual
from mnasnet_tpu_torch.ops.cuda import bn_bwd, dw_conv, mbconv
from mnasnet_tpu_torch.ops.cuda.bn_bwd import (
    _fwd_math,
    bn_bwd_dx,
    bn_bwd_dx_reference,
    bn_bwd_reduce,
    bn_bwd_reduce_reference,
    bn_relu_train,
    relu_mask_reference,
)
from mnasnet_tpu_torch.ops.cuda.dw_conv import (
    depthwise_conv_train,
    dw_conv_bn_act,
    dw_conv_reference,
)
from mnasnet_tpu_torch.ops.cuda.mbconv import mbconv_fused, mbconv_reference
from mnasnet_tpu_torch.ops.depthwise import depthwise_conv2d
from mnasnet_tpu_torch.train.optim import create_optimizer
from mnasnet_tpu_torch.train.state import TrainState
from mnasnet_tpu_torch.train.steps import make_train_step

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(out, ref, tol):
    """max |out - ref| within ``tol`` of the largest reference magnitude (the
    tolerances and their reasons are chip_smoke.py's)."""
    err = (out.float() - ref.float()).abs().max() / ref.float().abs().max()
    assert float(err) <= tol, float(err)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)])
@pytest.mark.parametrize("k,stride,hw,c", [
    (3, 1, 16, 32), (5, 1, 14, 48), (3, 2, 16, 32), (5, 2, 15, 8), (3, 1, 7, 160),
])
def test_dw_kernel_matches_plain(cuda, dtype, tol, k, stride, hw, c):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(3, hw, hw, c, device=cuda, generator=g).to(dtype)
    w = torch.randn(k, k, 1, c, device=cuda, generator=g) * 0.3
    s = torch.rand(c, device=cuda, generator=g) + 0.5
    b = torch.randn(c, device=cuda, generator=g)
    for relu in (True, False):
        before = dw_conv_bn_act.launches
        y = dw_conv_bn_act(x, w, s, b, stride=stride, relu=relu)
        torch.cuda.synchronize()
        assert dw_conv_bn_act.launches == before + 1
        assert y.dtype == dtype and y.is_contiguous()
        _close(y, dw_conv_reference(x, w, s, b, stride=stride, relu=relu), tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2.0 ** -6)])
@pytest.mark.parametrize("h,cin,cmid,cout,k,stride,res", [
    (16, 16, 48, 24, 3, 2, False),
    (16, 24, 72, 24, 3, 1, True),
    (14, 40, 240, 80, 5, 2, False),
    (7, 96, 576, 96, 3, 1, True),
    (15, 8, 24, 8, 5, 2, False),
    (30, 24, 72, 24, 5, 1, True),   # several tiles per sample, ragged edge
])
def test_mbconv_kernel_matches_plain(cuda, dtype, tol, h, cin, cmid, cout, k, stride, res):
    g = torch.Generator(device=cuda).manual_seed(1)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, device=cuda, generator=g) * scale

    x = r(2, h, h, cin).to(dtype)
    args = (x, r(cin, cmid, scale=cin ** -0.5), r(cmid).abs() + 0.5, r(cmid, scale=0.1),
            r(k, k, 1, cmid, scale=1 / k), r(cmid).abs() + 0.5, r(cmid, scale=0.1),
            r(cmid, cout, scale=cmid ** -0.5), r(cout).abs() + 0.5, r(cout, scale=0.1))
    kw = dict(kernel_size=k, stride=stride, residual=res)
    before = mbconv_fused.launches
    y = mbconv_fused(*args, **kw)
    torch.cuda.synchronize()
    assert mbconv_fused.launches == before + 1
    _close(y, mbconv_reference(*args, **kw), tol)


def test_smem_formulas_match_the_sources(cuda):
    dw_lib, mb_lib = dw_conv._lib(), mbconv._lib()
    for args in [(3, 1, 112, 7, 32, 7, 2, 2), (5, 2, 14, 14, 64, 2, 4, 4),
                 (5, 1, 7, 7, 192, 7, 7, 2)]:
        assert dw_lib.dw_conv_smem_bytes(*args) == dw_conv.smem_bytes(*args)
    for args in [(16, 16, 16, 16, 24, 3, 2, 2), (7, 7, 64, 192, 320, 3, 1, 4),
                 (14, 8, 32, 80, 80, 5, 1, 2), (7, 7, 48, 8, 40, 5, 1, 2),
                 (14, 14, 80, 24, 24, 3, 1, 2), (8, 8, 16, 8, 8, 5, 2, 4)]:
        assert mb_lib.mbconv_smem_bytes(*args) == mbconv.smem_bytes(*args)


def _dw_case(cuda, dtype, n, hw, c, k, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(n, hw, hw, c, device=cuda, generator=g).to(dtype)
    w = torch.randn(k, k, c, device=cuda, generator=g) * 0.3
    s = torch.rand(c, device=cuda, generator=g) + 0.5
    b = torch.randn(c, device=cuda, generator=g)
    return x, w, s, b


# Plans that hit the dw kernel's edges: a band that does not divide Ho, a
# step of rows side by side that does not divide the band, a strip that does
# not divide Wo, a channel group below C, C = 8, both strips, a band loaded
# whole and a ring that wraps at stride 2.
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)])
@pytest.mark.parametrize("hw,c,k,stride,th,cg,r,rp", [
    (16, 32, 3, 1, 5, 16, 7, 2),    # Ho = 16: bands of 5, steps of 2; cg < C; Wo = 16
    (15, 8, 5, 2, 3, 8, 7, 1),      # Wo = 8, Ho = 8 in bands of 3; C = 8
    (14, 24, 5, 1, 4, 24, 2, 4),    # Wo = 14 in strips of 2; each band whole
    (7, 48, 3, 1, 7, 16, 2, 7),     # Wo = 7 in strips of 2; the plane in one step
    (17, 40, 3, 2, 2, 40, 2, 1),    # Wo = 9 in strips of 2, odd H at stride 2
    (28, 16, 5, 2, 14, 16, 2, 4),   # a ring of 19 rows that wraps, stride 2
    (14, 24, 5, 1, 14, 24, 7, 7),   # strips of 7: two to a row
    (9, 16, 3, 1, 4, 8, 7, 2),      # Wo = 9 in strips of 7
])
def test_dw_kernel_plans_match_plain(cuda, dtype, tol, hw, c, k, stride, th, cg, r, rp):
    x, w, s, b = _dw_case(cuda, dtype, 2, hw, c, k)
    p = dw_conv.make_plan(2, hw, hw, c, k, stride, x.element_size(), th, cg, r, rp)
    for relu in (True, False):
        y = dw_conv.launch(x, w, s, b, stride, relu, p)
        y2 = dw_conv.launch(x, w, s, b, stride, relu, p)
        torch.cuda.synchronize()
        assert torch.equal(y, y2)  # no atomics: two launches bit-identical
        _close(y, dw_conv_reference(x, w, s, b, stride=stride, relu=relu), tol)


def _mb_args(cuda, dtype, n, h, cin, cmid, cout, k, seed=1):
    g = torch.Generator(device=cuda).manual_seed(seed)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, device=cuda, generator=g) * scale

    x = r(n, h, h, cin).to(dtype)
    return (x, r(cin, cmid, scale=cin ** -0.5), r(cmid).abs() + 0.5, r(cmid, scale=0.1),
            r(k, k, 1, cmid, scale=1 / k), r(cmid).abs() + 0.5, r(cmid, scale=0.1),
            r(cmid, cout, scale=cmid ** -0.5), r(cout).abs() + 0.5, r(cout, scale=0.1))


# Plans that hit the MBConv kernels' edges: Cin = 8 and Cmid = 24 (K padded
# to 16), Cout = 8 and Cout = 40 (odd n-tiles), a chunk that does not divide
# Cmid, ragged tiles with a residual, a 7x7 tile at several project items.
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2.0 ** -6)])
@pytest.mark.parametrize("h,cin,cmid,cout,k,stride,res,th,tw,mc", [
    (15, 8, 24, 8, 5, 2, False, 8, 8, 16),
    (20, 24, 72, 24, 3, 1, True, 8, 8, 32),
    (13, 40, 120, 40, 5, 1, True, 7, 4, 48),
    (7, 48, 288, 80, 3, 1, False, 7, 7, 128),
    (12, 16, 96, 40, 5, 2, False, 4, 6, 64),
])
def test_mbconv_kernel_plans_match_plain(cuda, dtype, tol, h, cin, cmid, cout, k, stride, res,
                                         th, tw, mc):
    args = _mb_args(cuda, dtype, 2, h, cin, cmid, cout, k)
    kw = dict(kernel_size=k, stride=stride, residual=res)
    eb = args[0].element_size()
    mc = mc if eb == 2 else min(mc, 64)
    assert mbconv.feasible(th, tw, mc, cin, cmid, cout, k, stride, eb, mbconv.THREADS)
    smem = mbconv.smem_bytes(th, tw, mc, cin, cout, k, stride, eb)
    p = mbconv.Plan(th, tw, mc, smem, 0, mbconv.THREADS)
    ops = mbconv.kernel_args(*args, kernel_size=k)
    y = mbconv.launch(*ops, stride=stride, residual=res, p=p)
    y2 = mbconv.launch(*ops, stride=stride, residual=res, p=p)
    torch.cuda.synchronize()
    assert torch.equal(y, y2)
    _close(y, mbconv_reference(*args, **kw), tol)


def test_model_kernel_route_matches_torch_route(cuda):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 3, 64, 64))
                         .astype(np.float32)).to(cuda)
    ref = create_model("mnasnet0_5", num_classes=10, dw_impl="torch")
    model = create_model("mnasnet0_5", num_classes=10, dw_impl="auto")
    model.load_state_dict(ref.state_dict())
    before = (dw_conv_bn_act.launches, mbconv_fused.launches)
    with torch.no_grad():
        out = model(x)
    torch.cuda.synchronize()
    assert (dw_conv_bn_act.launches - before[0], mbconv_fused.launches - before[1]) == (1, 16)
    with torch.no_grad():
        _close(out, ref(x), 1e-4)


def test_block_without_a_plan_takes_the_dw_kernel(cuda):
    from mnasnet_tpu_torch.models.mnasnet import InvertedResidual

    kernel = InvertedResidual(4096, 4096, 3, 1, 1, dw_impl="auto").to(cuda).eval()
    ref = InvertedResidual(4096, 4096, 3, 1, 1, dw_impl="torch").to(cuda).eval()
    g = torch.Generator(device=cuda).manual_seed(2)
    with torch.no_grad():
        for p in kernel.parameters():
            p.normal_(std=0.02, generator=g)
    ref.load_state_dict(kernel.state_dict())
    x = torch.randn(2, 4096, 7, 7, device=cuda).contiguous(memory_format=torch.channels_last)
    before = (dw_conv_bn_act.launches, mbconv_fused.launches)
    with torch.no_grad():
        out = kernel(x)
        torch.cuda.synchronize()
        assert (dw_conv_bn_act.launches - before[0], mbconv_fused.launches - before[1]) == (1, 0)
        _close(out, ref(x), 1e-4)


def test_cuda_wrappers_reject(cuda):
    x = torch.zeros(1, 8, 8, 16, device=cuda, dtype=torch.float16)
    w, s, b = (torch.zeros(3, 3, 1, 16, device=cuda), torch.ones(16, device=cuda),
               torch.zeros(16, device=cuda))
    with pytest.raises(TypeError):
        dw_conv_bn_act(x, w, s, b)
    with pytest.raises(ValueError, match="contiguous"):
        dw_conv_bn_act(torch.zeros(1, 16, 8, 8, device=cuda).permute(0, 2, 3, 1), w, s, b)
    with pytest.raises(ValueError, match="multiple of 8"):
        dw_conv_bn_act(torch.zeros(1, 8, 8, 15, device=cuda), w[..., :15], s[:15], b[:15])
    with pytest.raises(ValueError, match="multiple of 8"):
        dw_conv_bn_act(torch.zeros(1, 8, 8, 12, device=cuda), w[..., :12], s[:12], b[:12])


def _bn_case(cuda, shape, dtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    c = shape[-1]
    x = (torch.randn(*shape, device=cuda, generator=g) * 2 + 0.3).to(dtype)
    dy = torch.randn(*shape, device=cuda, generator=g).to(dtype)
    gamma = torch.rand(c, device=cuda, generator=g) + 0.5
    beta = torch.rand(c, device=cuda, generator=g) - 0.5
    y, mean, var = _fwd_math(x, gamma, beta, 1e-5, "one_pass")
    return x, dy, y, (mean, torch.rsqrt(var + 1e-5), gamma, beta)


# (dγ and dβ, dx) tolerances and their reasons are chip_smoke.py's. C = 8, 12
# and 6 reach the reduce's 16-, 8- and 4-byte vectors in bf16, C = 4 and 6
# its 16- and 8-byte vectors in fp32.
@pytest.mark.parametrize("dtype,tol_dx", [(torch.float32, 1e-4), (torch.bfloat16, 2.0 ** -7)])
@pytest.mark.parametrize("shape", [(2, 7, 7, 1280), (3, 15, 15, 72), (4, 8, 8, 16),
                                   (2, 56, 56, 144), (1, 1, 3, 2), (3, 9, 9, 8), (2, 5, 5, 12),
                                   (3, 5, 5, 6), (4, 6, 6, 4)])
def test_bn_kernels_match_plain(cuda, dtype, tol_dx, shape):
    x, dy, y, vecs = _bn_case(cuda, shape, dtype)
    before = (bn_bwd_reduce.launches, bn_bwd_dx.launches)
    dg, db = bn_bwd_reduce(x, dy, *vecs)
    dx = bn_bwd_dx(x, dy, *vecs, dg, db)
    torch.cuda.synchronize()
    assert (bn_bwd_reduce.launches, bn_bwd_dx.launches) == (before[0] + 1, before[1] + 1)
    rdg, rdb = bn_bwd_reduce_reference(x, dy, *vecs)
    _close(dg, rdg, 1e-4)
    _close(db, rdb, 1e-4)
    assert dx.dtype == dtype and dx.is_contiguous()
    _close(dx, bn_bwd_dx_reference(x, dy, *vecs, rdg, rdb), tol_dx)
    # Deterministic: no atomics, the same sums on every run.
    dg2, db2 = bn_bwd_reduce(x, dy, *vecs)
    assert torch.equal(dg, dg2) and torch.equal(db, db2)
    assert torch.equal(dx, bn_bwd_dx(x, dy, *vecs, dg2, db2))
    # The mask: with dy = 1, dβ counts the positive forward outputs exactly.
    _, count = bn_bwd_reduce(x, torch.ones_like(dy), *vecs)
    assert torch.equal(count, (y > 0).float().sum(dim=(0, 1, 2)))


@pytest.mark.parametrize("dtype,tol_dx", [(torch.float32, 1e-4), (torch.bfloat16, 2.0 ** -7)])
@pytest.mark.parametrize("n_factor", [2, 3])
def test_bn_dx_with_a_global_count(cuda, dtype, tol_dx, n_factor):
    """Sync-BN's dx: the count n is the global one (n_factor replicas of M
    rows), not the local M; the kernel against its plain version."""
    x, dy, _, vecs = _bn_case(cuda, (4, 14, 14, 96), dtype, seed=3)
    dg, db = bn_bwd_reduce_reference(x, dy, *vecs)
    dg, db = dg * n_factor, db * n_factor  # the sums over n_factor such replicas
    n = n_factor * x.numel() // x.shape[-1]
    before = bn_bwd_dx.launches
    dx = bn_bwd_dx(x, dy, *vecs, dg, db, n=n)
    torch.cuda.synchronize()
    assert bn_bwd_dx.launches == before + 1
    _close(dx, bn_bwd_dx_reference(x, dy, *vecs, dg, db, n=n), tol_dx)
    assert not torch.equal(dx, bn_bwd_dx(x, dy, *vecs, dg, db))


def test_bn_bwd_under_a_one_rank_group_is_bitwise_the_plain_call(cuda, tmp_path):
    """A 1-rank gloo group on CUDA tensors: the collective sums one tensor,
    the count is M, so dx, dγ and dβ equal the call without a group, bit for
    bit."""
    import torch.distributed as dist

    from mnasnet_tpu_torch.parallel import Replicas

    x, dy, _, (mean, inv, gamma, beta) = _bn_case(cuda, (4, 14, 14, 96), torch.bfloat16, seed=4)
    var = 1.0 / inv.square() - 1e-5
    plain = bn_bwd.bn_bwd(x, dy, mean, var, gamma, beta, 1e-5)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
                            world_size=1, rank=0)
    try:
        replicas = Replicas(0, 1, cuda)
        before = (bn_bwd_reduce.launches, bn_bwd_dx.launches)
        grouped = bn_bwd.bn_bwd(x, dy, mean, var, gamma, beta, 1e-5, replicas)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    assert (bn_bwd_reduce.launches, bn_bwd_dx.launches) == (before[0] + 1, before[1] + 1)
    # One check of the plane size, then the (2, C) sums: two collectives.
    assert replicas.collectives == 2
    for a, b in zip(plain, grouped):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_reduce_at_an_unaligned_offset(cuda, dtype):
    """A contiguous input that starts 300 (bf16) or 600 (fp32) bytes into its
    storage: the reduce takes the widest vector the address allows."""
    x, dy, y, vecs = _bn_case(cuda, (3, 5, 5, 6), dtype, seed=2)
    x, dy, y = x[1:], dy[1:], y[1:]
    assert x.is_contiguous() and x.data_ptr() % 16 and dy.data_ptr() % 16
    _, mean, var = _fwd_math(x, vecs[2], vecs[3], 1e-5, "one_pass")
    vecs = (mean, torch.rsqrt(var + 1e-5), vecs[2], vecs[3])
    dg, db = bn_bwd_reduce(x, dy, *vecs)
    rdg, rdb = bn_bwd_reduce_reference(x, dy, *vecs)
    _close(dg, rdg, 1e-4)
    _close(db, rdb, 1e-4)
    _, count = bn_bwd_reduce(x, torch.ones_like(dy), *vecs)
    assert torch.equal(count, (relu_mask_reference(x, *vecs)).float().sum(dim=(0, 1, 2)))


def test_bn_reduce_back_to_back_shapes(cuda):
    """Launches over different shapes in a row, each bit-identical to a
    second launch of its own: every launch leaves its tickets at 0."""
    cases = [_bn_case(cuda, shape, dtype, seed=i) for i, (shape, dtype) in enumerate([
        ((2, 28, 28, 120), torch.bfloat16), ((4, 7, 7, 1152), torch.bfloat16),
        ((3, 5, 5, 6), torch.float32), ((2, 56, 56, 48), torch.bfloat16),
        ((2, 14, 14, 480), torch.float32)])]
    first = [bn_bwd_reduce(x, dy, *vecs) for x, dy, _, vecs in cases]
    second = [bn_bwd_reduce(x, dy, *vecs) for x, dy, _, vecs in cases]
    torch.cuda.synchronize()
    for (x, dy, _, vecs), (dg, db), (dg2, db2) in zip(cases, first, second):
        assert torch.equal(dg, dg2) and torch.equal(db, db2)
        rdg, rdb = bn_bwd_reduce_reference(x, dy, *vecs)
        _close(dg, rdg, 1e-4)
        _close(db, rdb, 1e-4)


def test_bn_reduce_in_a_cuda_graph(cuda):
    """One reduce captured in a CUDA graph and replayed twice gives the eager
    sums, bit for bit."""
    x, dy, _, vecs = _bn_case(cuda, (4, 14, 14, 240), torch.bfloat16, seed=3)
    dg, db = bn_bwd_reduce(x, dy, *vecs)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gdg, gdb = bn_bwd_reduce(x, dy, *vecs)
    for _ in range(2):
        gdg.zero_()
        gdb.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(gdg, dg) and torch.equal(gdb, db)


# Plans that hit the reduce's edges: one slab (the only block finishes),
# a ragged last tile, slabs of a few rows that the lanes do not divide, many
# slabs against few channels, and two lanes per block with wide tiles.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,tg,slabs", [
    ((2, 9, 9, 72), 9, 1), ((2, 9, 9, 72), 4, 7), ((3, 7, 7, 40), 2, 147),
    ((2, 28, 28, 16), 1, 200), ((1, 4, 4, 2048), 128, 3),
])
def test_bn_reduce_plans_match_plain(cuda, dtype, shape, tg, slabs):
    x, dy, _, vecs = _bn_case(cuda, shape, dtype, seed=4)
    m, c = x.numel() // shape[-1], shape[-1]
    p = bn_bwd.make_reduce_plan(m, c, x.element_size(), 16, tg, slabs)
    out = bn_bwd.launch_reduce(x, dy, *vecs, p)
    out2 = bn_bwd.launch_reduce(x, dy, *vecs, p)
    torch.cuda.synchronize()
    assert torch.equal(out, out2)
    rdg, rdb = bn_bwd_reduce_reference(x, dy, *vecs)
    _close(out[0], rdg, 1e-4)
    _close(out[1], rdb, 1e-4)


def test_bn_relu_train_on_the_kernels(cuda):
    """The region Function against autograd of its own forward, in fp32 (in
    bf16 autograd rounds the β cotangent to bf16 through the shift cast and
    is no oracle; the mask-count check above holds bf16), at the tolerance
    of tests/test_bn_bwd.py:58-60."""
    x, dy, _, (_, _, gamma, beta) = _bn_case(cuda, (4, 14, 14, 72), torch.float32, seed=1)
    xs = [x.detach().requires_grad_() for _ in range(2)]
    gs = [gamma.detach().requires_grad_() for _ in range(2)]
    bs = [beta.detach().requires_grad_() for _ in range(2)]
    before = (bn_bwd_reduce.launches, bn_bwd_dx.launches)
    y, _, _ = bn_relu_train(xs[0], gs[0], bs[0], 1e-5, "one_pass")
    y.backward(dy)
    assert (bn_bwd_reduce.launches, bn_bwd_dx.launches) == (before[0] + 1, before[1] + 1)
    # The same region through autograd of the plain forward.
    _fwd_math(xs[1], gs[1], bs[1], 1e-5, "one_pass")[0].backward(dy)
    for ours, ref in ((xs[0].grad, xs[1].grad), (gs[0].grad, gs[1].grad),
                      (bs[0].grad, bs[1].grad)):
        torch.testing.assert_close(ours, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, (1e-4, 1e-4)),
                                       (torch.bfloat16, (2.0 ** -7, 2.0 ** -6))])
@pytest.mark.parametrize("k,stride,hw,c", [(3, 1, 16, 32), (5, 2, 15, 24), (3, 2, 28, 48),
                                           (5, 2, 56, 72)])
def test_dw_train_function_matches_torch_route(cuda, dtype, tol, k, stride, hw, c):
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(2, hw, hw, c, device=cuda, generator=g).to(dtype)
    w = torch.randn(k, k, 1, c, device=cuda, generator=g) * 0.3
    grads = []
    for fn in (lambda a, b: depthwise_conv_train(a, b, stride=stride),
               lambda a, b: depthwise_conv2d(a, b, stride=stride, impl="torch")):
        xr, wr = x.detach().requires_grad_(), w.detach().requires_grad_()
        y = fn(xr, wr)
        cot = torch.randn(y.shape, device=cuda, generator=torch.Generator(device=cuda)
                          .manual_seed(4)).to(dtype)
        grads.append(torch.autograd.grad(y, (xr, wr), cot))
    (dx, dw), (tdx, tdw) = grads
    assert dx.dtype == dtype and dw.dtype == torch.float32
    _close(dx, tdx, tol[0])
    _close(dw, tdw, tol[1])


def test_raw_wrappers_refuse_autograd(cuda):
    x = torch.randn(1, 8, 8, 16, device=cuda, requires_grad=True)
    w = torch.randn(3, 3, 1, 16, device=cuda)
    s, b = torch.ones(16, device=cuda), torch.zeros(16, device=cuda)
    with pytest.raises(RuntimeError, match="autograd"):
        dw_conv_bn_act(x, w, s, b)
    with pytest.raises(RuntimeError, match="autograd"):
        dw_conv_bn_act(x.detach(), w.requires_grad_(), s, b)
    with torch.no_grad():
        dw_conv_bn_act(x, w, s, b)  # allowed: nothing is recorded
    mb = (torch.randn(16, 48, device=cuda), s.new_ones(48), s.new_zeros(48),
          torch.randn(3, 3, 1, 48, device=cuda), s.new_ones(48), s.new_zeros(48),
          torch.randn(48, 16, device=cuda), s, b)
    with pytest.raises(RuntimeError, match="autograd"):
        mbconv_fused(x, *mb, kernel_size=3, stride=1, residual=True)
    vecs = (s, s, s, b)
    with pytest.raises(RuntimeError, match="autograd"):
        bn_bwd_reduce(x, torch.ones_like(x), *vecs)
    with pytest.raises(RuntimeError, match="autograd"):
        bn_bwd_dx(x, torch.ones_like(x), *vecs, s, b)


def test_fused_block_is_off_in_train_mode(cuda):
    block = InvertedResidual(24, 24, 3, 1, 3, dw_impl="auto").to(cuda)
    x = torch.randn(4, 24, 16, 16, device=cuda).contiguous(memory_format=torch.channels_last)
    assert block.eval()._use_fused_block(x, "kernel")
    assert not block.train()._use_fused_block(x, "kernel")
    before = (mbconv_fused.launches, dw_conv_bn_act.launches, bn_bwd_reduce.launches)
    block(x.requires_grad_()).float().sum().backward()
    torch.cuda.synchronize()
    assert (mbconv_fused.launches - before[0], dw_conv_bn_act.launches - before[1],
            bn_bwd_reduce.launches - before[2]) == (0, 1, 2)
    assert x.grad is not None and block.layers[0].weight.grad is not None


def test_train_step_kernel_route_matches_torch_route(cuda):
    rng = np.random.default_rng(5)
    images = rng.standard_normal((8, 64, 64, 3)).astype(np.float32)
    labels = rng.integers(0, 10, 8)
    out = []
    for route in ("kernel", "torch"):
        model = create_model("mnasnet0_5", num_classes=10, dropout=0.0, dw_impl=route,
                             bn_bwd=route, bn_ema="external", stem_s2d=True, seed=2)
        tx = create_optimizer("rmsprop", 1e-4, fused="small")
        state = TrainState.create(model, tx)
        state, metrics = make_train_step(model, tx, 0.1)(state, images, labels)
        out.append((float(metrics["loss"]), model.state_dict()))
    (lk, sk), (lt, st) = out
    assert abs(lk - lt) <= 1e-5 * abs(lt)
    for k in st:
        if k.endswith(("running_mean", "running_var")):
            _close(sk[k], st[k], 1e-5)
        elif not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(sk[k], st[k], rtol=5e-3, atol=1e-4)


def test_prefetch_to_device_on_the_card(cuda):
    """The side-stream copy delivers the CPU cast's values, on the card, to a
    consumer stream that may use them at once; an early exit stops it."""
    import threading

    from mnasnet_tpu_torch.data.pipeline import prefetch_to_device

    rng = np.random.default_rng(0)
    batches = [((rng.standard_normal((16, 32, 32, 3)) * 3).astype(np.float32),
                rng.integers(-1, 10, 16).astype(np.int32)) for _ in range(6)]
    ref = list(prefetch_to_device(iter(batches), device="cpu", dtype=torch.bfloat16))
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):  # the consumer on a stream of its own
        got = [(x, y, x.float().sum(), y.sum()) for x, y in
               prefetch_to_device(iter(batches), device=cuda, dtype=torch.bfloat16)]
    torch.cuda.synchronize()
    assert len(got) == len(ref)
    for (x, y, xs, ys), (rx, ry) in zip(got, ref):
        assert x.is_cuda and x.dtype == torch.bfloat16 and y.dtype == torch.int32
        assert torch.equal(x.cpu(), rx) and torch.equal(y.cpu(), ry)
        # The sums the consumer's stream took saw the copied values.
        assert torch.equal(xs, rx.to(cuda).float().sum()) and int(ys) == int(ry.sum())

    before = {t.ident for t in threading.enumerate()}
    it = prefetch_to_device(iter(batches * 10), device=cuda)
    next(it)
    it.close()
    assert not ({t.ident for t in threading.enumerate()} - before)


def test_trainer_stop_and_resume_is_bitwise_on_the_card(cuda, tmp_path, monkeypatch):
    """Trainer.train_epoch with the kernels under deterministic algorithms:
    stopped after step 2, checkpointed, restored and resumed, the same bits
    as the uninterrupted run; 17 dw, 35 + 35 BN and no MBConv launches a
    step."""
    from mnasnet_tpu_torch.data.dataset import SyntheticDataset
    from mnasnet_tpu_torch.data.pipeline import DataLoader
    from mnasnet_tpu_torch.data.transforms import train_transform
    from mnasnet_tpu_torch.train.checkpoint import CheckpointManager
    from mnasnet_tpu_torch.train.trainer import Trainer

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    loader = DataLoader(SyntheticDataset(64, 64, 10, seed=0), 16,
                        lambda img, rng: train_transform(img, 64, rng), shuffle=True,
                        drop_last=True, workers=2)

    def fresh():
        model = create_model("mnasnet0_35", num_classes=10, dtype=torch.bfloat16,
                             bn_ema="external", stem_s2d=True, bn_stats="two_pass")
        tx = create_optimizer("rmsprop", 1e-3, fused="small", model_ema=0.9)
        trainer = Trainer(model, tx, compute_dtype=torch.bfloat16, print_freq=1000)
        return model, tx, trainer, trainer.create_state(0)

    previous = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        ma, txa, ta, sa = fresh()
        before = dw_conv_bn_act.launches, bn_bwd_reduce.launches, bn_bwd_dx.launches, \
            mbconv_fused.launches
        sa = ta.train_epoch(sa, loader, 0)
        after = dw_conv_bn_act.launches, bn_bwd_reduce.launches, bn_bwd_dx.launches, \
            mbconv_fused.launches
        assert [b - a for a, b in zip(before, after)] == [17 * 4, 35 * 4, 35 * 4, 0]

        mb, txb, tb, sb = fresh()
        sb = tb.train_epoch(sb, loader, 0, step_callback=lambda s, g: tb.request_stop(),
                            step_callback_freq=2)
        assert tb.next_global_step == 2
        CheckpointManager(str(tmp_path)).save(2, mb, txb, sb, 0.0, 0.0)
        mc, txc, tc, sc = fresh()
        CheckpointManager(str(tmp_path)).restore(mc, txc, sc)
        sc = tc.train_epoch(sc, loader, 0, start_step=2)
    finally:
        torch.use_deterministic_algorithms(previous)
    for a, c in ((ma.state_dict(), mc.state_dict()),
                 (txa.state_dict()["ema_params"], txc.state_dict()["ema_params"]),
                 (txa.state_dict()["inner"]["mom"], txc.state_dict()["inner"]["mom"])):
        assert a.keys() == c.keys()
        for k in a:
            assert torch.equal(a[k], c[k]), k
    assert sa.state_dict()["step"] == sc.state_dict()["step"] == 4
    assert torch.equal(sa.generator.get_state(), sc.generator.get_state())


# ------------------------------------------------- the ops and the routes


def _dw_op_case(cuda, h, c, k, dtype, batch=16, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(batch, h, h, c, device=cuda, generator=g).to(dtype)
    w = torch.randn(k, k, 1, c, device=cuda, generator=g) * 0.3
    return x, w, torch.rand(c, device=cuda, generator=g) + 0.5, \
        torch.randn(c, device=cuda, generator=g) * 0.1


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)])
@pytest.mark.parametrize("i", range(12))
def test_dw_op_cuda_impl_matches_its_cpu_impl(cuda, dtype, tol, i):
    """``torch.ops.mnasnet_tpu_torch.dw_conv_bn_act`` through the dispatcher at
    each depthwise shape of mnasnet1_0@224 (batch 16): the CUDA impl (one
    counted launch) against the CPU impl on the same inputs."""
    from mnasnet_tpu_torch.tools.tune_plans import dw_shapes

    h, c, k, s = dw_shapes()[i]
    x, w, scale, bias = _dw_op_case(cuda, h, c, k, dtype, seed=i)
    op = torch.ops.mnasnet_tpu_torch.dw_conv_bn_act.default
    before = dw_conv_bn_act.launches
    y = op(x, w, scale, bias, s, True)
    torch.cuda.synchronize()
    assert dw_conv_bn_act.launches - before == 1 and y.is_cuda and y.dtype == dtype
    _close(y.cpu(), op(x.cpu(), w.cpu(), scale.cpu(), bias.cpu(), s, True), tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2.0 ** -6)])
@pytest.mark.parametrize("i", range(16))
def test_mbconv_op_cuda_impl_matches_its_cpu_impl(cuda, dtype, tol, i):
    """``torch.ops.mnasnet_tpu_torch.mbconv_block`` at each block of
    mnasnet1_0@224 (batch 8): the CUDA impl against the CPU impl."""
    from mnasnet_tpu_torch.tools.tune_plans import block_shapes, random_block

    _, h, cin, cmid, cout, k, s = block_shapes()[i]
    g = torch.Generator(device=cuda).manual_seed(i)
    _, (x32, *weights), kw = random_block(h, cin, cmid, cout, k, s, g)
    x = x32[:8].to(dtype).contiguous()
    op = torch.ops.mnasnet_tpu_torch.mbconv_block.default
    args = (kw["kernel_size"], kw["stride"], kw["residual"])
    before = mbconv_fused.launches
    y = op(x, *weights, *args)
    torch.cuda.synchronize()
    assert mbconv_fused.launches - before == 1 and y.is_cuda and y.dtype == dtype
    _close(y.cpu(), op(x.cpu(), *(t.cpu() for t in weights), *args), tol)


def test_graph_route_equals_eager_and_keeps_held_results(cuda):
    """The graph route's logits equal eager's bit for bit; a replay returns a
    copy, so two held results stay intact after a third call; the kernels'
    counters advance at the warm-up and the capture, not at a replay."""
    from mnasnet_tpu_torch.train.steps import make_predict_fn
    from mnasnet_tpu_torch.utils.routing import GRAPH_WARMUP, BatchRouted

    model = create_model("mnasnet0_5", num_classes=10, dtype=torch.bfloat16, dw_impl="kernel")
    predict = make_predict_fn(model)
    g = torch.Generator(device=cuda).manual_seed(0)
    xs = [torch.randn(4, 64, 64, 3, device=cuda, generator=g) for _ in range(3)]
    routed = BatchRouted(predict, route_for=lambda bs: "graph")
    before = (dw_conv_bn_act.launches, mbconv_fused.launches)
    held = [routed(xs[0]), routed(xs[1])]
    copies = [h.clone() for h in held]
    third = routed(xs[2])
    torch.cuda.synchronize()
    calls = GRAPH_WARMUP + 1
    assert (dw_conv_bn_act.launches - before[0], mbconv_fused.launches - before[1]) == \
        (calls, 16 * calls)
    assert list(routed.replays.values()) == [3]
    assert all(torch.equal(h, c) for h, c in zip(held, copies))
    for x, out in zip(xs, [*held, third]):
        assert torch.equal(out, predict(x))


def test_compile_of_the_model_on_the_card_keeps_the_ops_opaque(cuda):
    """torch.compile(fullgraph=True) with Inductor on the card: the graph holds
    the 17 kernel ops, each compiled call launches them (1 + 16), and the
    logits meet the serving phase's bf16 bar against eager."""
    from torch._inductor.compile_fx import compile_fx

    ops = ("mnasnet_tpu_torch.dw_conv_bn_act", "mnasnet_tpu_torch.mbconv_block")
    graphs = []

    def backend(gm, example_inputs):
        graphs.append([str(n.target) for n in gm.graph.nodes if n.op == "call_function"])
        return compile_fx(gm, example_inputs)

    model = create_model("mnasnet0_5", num_classes=10, dtype=torch.bfloat16, dw_impl="kernel")
    x = torch.randn(8, 3, 64, 64, device=cuda)
    with torch.no_grad():
        want = model(x)
        compiled = torch.compile(model, backend=backend, fullgraph=True)
        compiled(x)
        before = (dw_conv_bn_act.launches, mbconv_fused.launches)
        got = compiled(x)
    torch.cuda.synchronize()
    assert len(graphs) == 1
    assert [sum(op in t for t in graphs[0]) for op in ops] == [1, 16]
    assert (dw_conv_bn_act.launches - before[0], mbconv_fused.launches - before[1]) == (1, 16)
    assert float((got - want).abs().max()) <= 0.25 * float(want.abs().max())


def test_artifact_traced_on_the_cpu_serves_on_the_card(cuda):
    """An artifact traced on the CPU, moved to the card by load_serving: its
    eager route equals the live forward on the card bit for bit, with 1 dw
    and 16 MBConv launches a call."""
    from mnasnet_tpu_torch.serving import load_serving
    from mnasnet_tpu_torch.tools.export_serving import build_forward, export_artifact

    fn, x = build_forward("mnasnet0_5", 10, "bfloat16", None, 64, 4, device="cpu")
    data = export_artifact(fn, x, symbolic_batch=True)
    predict = load_serving(data, route="eager")
    live = fn.to(cuda)
    img = torch.randn(6, 64, 64, 3, device=cuda)
    before = (dw_conv_bn_act.launches, mbconv_fused.launches)
    got = predict(img)
    torch.cuda.synchronize()
    assert (dw_conv_bn_act.launches - before[0], mbconv_fused.launches - before[1]) == (1, 16)
    with torch.no_grad():
        assert torch.equal(got, live(img))
    # The compile route of the same artifact (Inductor, the ops opaque): each
    # call launches the kernels; the logits within the serving bf16 bar.
    compiled = load_serving(data, route="compile")
    compiled(img)
    before = (dw_conv_bn_act.launches, mbconv_fused.launches)
    out = compiled(img)
    torch.cuda.synchronize()
    assert (dw_conv_bn_act.launches - before[0], mbconv_fused.launches - before[1]) == (1, 16)
    assert float((out - got).abs().max()) <= 0.25 * float(got.abs().max())
