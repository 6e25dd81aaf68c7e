"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips (inside the test) where
``torch.cuda.is_available()`` is false. This file imports neither JAX nor the
JAX package, so it also runs on a machine with only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu
"""

import gc

import numpy as np
import pytest
import torch

from mnasnet_tpu_torch import create_model
from mnasnet_tpu_torch.models.mnasnet import InvertedResidual
from mnasnet_tpu_torch.ops.cuda import bn_bwd, dw_conv, mbconv
from mnasnet_tpu_torch.ops.cuda.bn_bwd import (
    _fwd_math,
    batch_moments,
    bn_bwd_dx,
    bn_bwd_dx_reference,
    bn_bwd_reduce,
    bn_bwd_reduce_reference,
    bn_fwd_stats,
    bn_fwd_stats_reference,
    bn_relu_apply,
    bn_relu_train,
    region_moments,
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
from mnasnet_tpu_torch.tools.tune_plans import bn_region_shapes
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


def _close_moments(ours: dict, ref: dict, tol: float):
    """Every BN's running statistics of two state dicts within ``tol``: each
    channel's mean in units of its standard deviation and its variance
    relative to itself (a mean near 0 has no relative error to speak of, and
    routes that sum the moments in different orders differ there by
    rounding alone)."""
    for n, v in ref.items():
        if n.endswith("running_var"):
            m = n[:-len("var")] + "mean"
            assert float(((ours[m] - ref[m]).abs() / v.clamp(min=1e-12).sqrt()).max()) <= tol, m
            assert float(((ours[n] - v).abs() / v.clamp(min=1e-12)).max()) <= tol, n


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
    before = (bn_fwd_stats.launches, bn_relu_apply.launches, bn_bwd_reduce.launches,
              bn_bwd_dx.launches)
    y, _, _ = bn_relu_train(xs[0], gs[0], bs[0], 1e-5, "one_pass")
    y.backward(dy)
    assert (bn_fwd_stats.launches, bn_relu_apply.launches, bn_bwd_reduce.launches,
            bn_bwd_dx.launches) == tuple(b + 1 for b in before)
    # The same region through autograd of the plain forward.
    _fwd_math(xs[1], gs[1], bs[1], 1e-5, "one_pass")[0].backward(dy)
    for ours, ref in ((xs[0].grad, xs[1].grad), (gs[0].grad, gs[1].grad),
                      (bs[0].grad, bs[1].grad)):
        torch.testing.assert_close(ours, ref, rtol=2e-4, atol=2e-4)


# ------------------------------------------------- the region's forward

# The distinct (H, C) of the 35 BN+ReLU regions of mnasnet1_0@224.
REGION_SHAPES = sorted({(h, c) for _, h, c in bn_region_shapes()})
# Widths that reach the forward kernels' 16-, 8- and 4-byte vectors (as the
# reduce's cases above), and a single row.
SMALL_BN_SHAPES = [(1, 1, 3, 2), (3, 9, 9, 8), (2, 5, 5, 12), (3, 5, 5, 6), (4, 6, 6, 4)]


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _moment_errors(x, mean, var):
    """(mean's error in standard deviations, var's relative error), worst
    channel, against float64 moments of x."""
    x64 = x.double()
    m64 = x64.mean(dim=(0, 1, 2))
    v64 = x64.var(dim=(0, 1, 2), unbiased=False)
    return (float(((mean.double() - m64).abs() / v64.sqrt()).max()),
            float(((var.double() - v64).abs() / v64).max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_relu_apply_is_the_plain_forward_bit_for_bit(cuda, dtype):
    """At the 35 region shapes of mnasnet1_0@224 (batch 2) and the small
    widths, given the plain forward's mean and var: the apply kernel gives
    the bits of ``relu(x·inv + shift)`` as its two ops round it, and its
    ``y > 0`` is the backward's recomputed mask."""
    cases = [(2, h, h, c) for _, h, c in bn_region_shapes()] + SMALL_BN_SHAPES
    for i, shape in enumerate(cases):
        x, _, y_plain, vecs = _bn_case(cuda, shape, dtype, seed=i)
        before = bn_relu_apply.launches
        y = bn_relu_apply(x, *vecs)
        torch.cuda.synchronize()
        assert bn_relu_apply.launches == before + 1
        assert y.dtype == dtype and y.shape == x.shape and y.is_contiguous()
        assert torch.equal(_bits(y), _bits(y_plain)), shape
        assert torch.equal(y > 0, relu_mask_reference(x, *vecs)), shape


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_relu_apply_at_an_unaligned_offset(cuda, dtype):
    """x 300 (bf16) or 600 (fp32) bytes into its storage: the apply kernel
    takes the widest vector both addresses allow, and the same bits."""
    x, _, y_plain, vecs = _bn_case(cuda, (3, 5, 5, 6), dtype, seed=2)
    x, y_plain = x[1:], y_plain[1:]
    assert x.is_contiguous() and x.data_ptr() % 16
    _, mean, var = _fwd_math(x, vecs[2], vecs[3], 1e-5, "one_pass")
    vecs = (mean, torch.rsqrt(var + 1e-5), vecs[2], vecs[3])
    assert torch.equal(_bits(bn_relu_apply(x, *vecs)),
                       _bits(_fwd_math(x, vecs[2], vecs[3], 1e-5, "one_pass")[0]))
    sums = bn_fwd_stats(x)
    torch.testing.assert_close(sums, bn_fwd_stats_reference(x), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stats", ["one_pass", "two_pass"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_fwd_stats_against_float64(cuda, dtype, stats):
    """The moments from the stats kernel's sums (``region_moments``) at the
    distinct region shapes (batch 2) and the small widths, against float64
    moments of the same x: the mean's error in standard deviations and the
    variance's relative error each within the plain fp32 path's own
    (``batch_moments`` on the card), floored at 2^-20. ``two_pass`` launches
    the kernel twice."""
    cases = [(2, h, h, c) for h, c in REGION_SHAPES] + SMALL_BN_SHAPES
    for i, shape in enumerate(cases):
        x = _bn_case(cuda, shape, dtype, seed=10 + i)[0]
        before = bn_fwd_stats.launches
        mean, var = region_moments(x, stats)
        torch.cuda.synchronize()
        assert bn_fwd_stats.launches - before == (1 if stats == "one_pass" else 2)
        assert mean.dtype == var.dtype == torch.float32
        ours = _moment_errors(x, mean, var)
        plain = _moment_errors(x, *batch_moments(x, stats))
        for e, p in zip(ours, plain):
            assert e <= max(p, 2.0 ** -20), (shape, ours, plain)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_forward_kernels_repeat_and_replay_bit_for_bit(cuda, dtype):
    """Two launches of each forward kernel give the same bits (a fixed order
    of sums, no float atomics), back to back over shapes; a CUDA graph of
    them, replayed twice, gives the eager bits."""
    cases = [_bn_case(cuda, shape, dtype, seed=i) for i, shape in enumerate(
        [(4, 14, 14, 240), (2, 56, 56, 48), (3, 5, 5, 6), (2, 7, 7, 1280)])]

    def run(x, vecs):
        mean = vecs[0]
        return bn_fwd_stats(x), bn_fwd_stats(x, mean), bn_relu_apply(x, *vecs)

    first = [run(x, vecs) for x, _, _, vecs in cases]
    second = [run(x, vecs) for x, _, _, vecs in cases]
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert all(torch.equal(_bits(u), _bits(v)) for u, v in zip(a, b))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = [run(x, vecs) for x, _, _, vecs in cases]
    for _ in range(2):
        for outs in captured:
            for t in outs:
                t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(first, captured):
            assert all(torch.equal(_bits(u), _bits(v)) for u, v in zip(a, b))


@pytest.mark.parametrize("stats", ["one_pass", "two_pass"])
def test_bn_relu_train_region_matches_autograd_of_the_plain_forward(cuda, stats):
    """The region, forward on the two forward kernels and backward on the
    other two, against autograd of the plain forward (``_fwd_math``) in fp32,
    at the tolerance of tests/test_bn_bwd.py:58-60 (the moments' summation
    order differs, so y is not bit for bit); each kernel launches once, the
    stats kernel twice under ``two_pass``."""
    x, dy, _, (_, _, gamma, beta) = _bn_case(cuda, (4, 28, 28, 120), torch.float32, seed=5)
    xs = [x.detach().requires_grad_() for _ in range(2)]
    gs = [gamma.detach().requires_grad_() for _ in range(2)]
    bs = [beta.detach().requires_grad_() for _ in range(2)]
    counters = (bn_fwd_stats, bn_relu_apply, bn_bwd_reduce, bn_bwd_dx)
    before = [f.launches for f in counters]
    y, mean, var = bn_relu_train(xs[0], gs[0], bs[0], 1e-5, stats)
    y.backward(dy)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == \
        [1 if stats == "one_pass" else 2, 1, 1, 1]
    yr, mr, vr = _fwd_math(xs[1], gs[1], bs[1], 1e-5, stats)
    yr.backward(dy)
    torch.testing.assert_close(mean, mr, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(var, vr, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(y, yr, rtol=2e-4, atol=2e-4)
    for ours, ref in ((xs[0].grad, xs[1].grad), (gs[0].grad, gs[1].grad),
                      (bs[0].grad, bs[1].grad)):
        torch.testing.assert_close(ours, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("bn_stats,stats_per_step", [("one_pass", 35), ("two_pass", 70)])
def test_bn_forward_launches_per_counted_graph_step(cuda, bn_stats, stats_per_step):
    """The graph route's step launches the forward kernels at each of the 35
    regions, per counted step (the warm-up and the capture; a replay
    launches without the wrappers): the stats kernel once a region, twice
    under ``two_pass``."""
    model, tx, state = _route_setup(cuda, bn_stats=bn_stats)
    step = make_train_step(model, tx, 0.1, route="graph")
    images, labels = _route_batch(cuda)
    before = (bn_fwd_stats.launches, bn_relu_apply.launches)
    for _ in range(3):
        state, _ = step(state, images, labels)
    torch.cuda.synchronize()
    n = step.counted()
    assert n == 2 and sum(step.replays.values()) == 2
    assert (bn_fwd_stats.launches - before[0], bn_relu_apply.launches - before[1]) == \
        (stats_per_step * n, 35 * n)


@pytest.mark.parametrize("stats", ["one_pass", "two_pass"])
def test_an_empty_band_launches_no_bn_kernel(cuda, stats):
    """A band of no rows (a plane with fewer rows than ranks): the region's
    forward and backward launch nothing; y and dx are empty, dγ and dβ 0."""
    x = torch.empty(2, 0, 7, 16, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    gamma = torch.ones(16, device=cuda, requires_grad=True)
    beta = torch.zeros(16, device=cuda, requires_grad=True)
    counters = (bn_fwd_stats, bn_relu_apply, bn_bwd_reduce, bn_bwd_dx)
    before = [f.launches for f in counters]
    y, _, _ = bn_relu_train(x, gamma, beta, 1e-5, stats)
    y.float().sum().backward()
    torch.cuda.synchronize()
    assert [f.launches for f in counters] == before
    assert y.shape == x.shape and x.grad.shape == x.shape
    assert not gamma.grad.any() and not beta.grad.any()


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
    _close_moments(sk, st, 1e-5)
    for k in st:
        if not k.endswith(("running_mean", "running_var", "num_batches_tracked")):
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
    """Trainer.train_epoch with the kernels under deterministic algorithms,
    on the default train route: stopped after step 2, checkpointed, restored
    and resumed (a new graph, captured at step 3), the same bits as the
    uninterrupted run; 17 dw, 35 + 35 BN and no MBConv launches a counted
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
        # The default train route: the steps the counters see (a graph's
        # warm-up and capture, not its replays) of 4 calls.
        n = ta._train_step.counted()
        assert sum(ta._train_step.calls.values()) == 4
        assert [b - a for a, b in zip(before, after)] == [17 * n, 35 * n, 35 * n, 0]

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


# ------------------------------------------------------ the train route


def _route_setup(cuda, seed=3, dtype=torch.bfloat16, dropout=0.2, lr=None, **model_kw):
    """mnasnet0_35 and RMSProp with the model EMA; the rate ``lr``, or by
    default warmup-cosine from 0, which changes at every one of 5 steps."""
    from mnasnet_tpu_torch.train.schedules import make_schedule

    model = create_model("mnasnet0_35", num_classes=10, dtype=dtype, bn_ema="external",
                         stem_s2d=True, dropout=dropout, seed=seed, **model_kw)
    tx = create_optimizer("rmsprop", lr or make_schedule("cosine", 1e-3, 5, 2, warmup_epochs=1),
                          fused="small", model_ema=0.99)
    return model, tx, TrainState.create(model, tx, seed=seed)


def _route_batch(cuda, n=16, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return (torch.randn(n, 64, 64, 3, device=cuda, generator=g),
            torch.randint(0, 10, (n,), device=cuda, generator=g))


def _snapshot(model, tx, state):
    def tree(d):
        return {k: tree(v) if isinstance(v, dict) else (v.clone() if torch.is_tensor(v) else v)
                for k, v in d.items()}

    return {"model": tree(model.state_dict()), "tx": tree(tx.state_dict()),
            "generator": state.generator.get_state(), "step": state.step}


def _assert_same(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


@pytest.fixture
def deterministic(cuda, monkeypatch):
    """Bitwise comparisons of steps run under deterministic algorithms."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    previous = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield cuda
    torch.use_deterministic_algorithms(previous)


def _run(cuda, routes, batches, grad_accum=1, restore_at=None, **model_kw):
    """Steps on ``routes`` (one per step) over ``batches``, on one state;
    with ``restore_at=(i, j)`` the state after step i is saved and loaded
    back, in place, after step j, and the steps after it run again."""
    model, tx, state = _route_setup(cuda, **model_kw)
    steps = {r: make_train_step(model, tx, 0.1, grad_accum=grad_accum, route=r)
             for r in set(routes)}
    losses, saved, i = [], None, 0
    while i < len(routes):
        state, metrics = steps[routes[i]](state, *batches[i])
        losses.append(metrics["loss"])
        if restore_at and i + 1 == restore_at[0] and saved is None:
            saved = (model.state_dict(), tx.state_dict(), state.state_dict())
            saved = tuple({k: (v.clone() if torch.is_tensor(v) else v) for k, v in d.items()}
                          if isinstance(d, dict) else d for d in saved)
        if restore_at and i + 1 == restore_at[1] and saved is not None:
            model.load_state_dict(saved[0])
            tx.load_state_dict(saved[1])
            state.load_state_dict(saved[2])
            losses = losses[:restore_at[0]]
            i, restore_at = restore_at[0], None
            continue
        i += 1
    torch.cuda.synchronize()
    return [float(v) for v in losses], _snapshot(model, tx, state), steps


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_graph_train_route_is_bitwise_eager(deterministic, grad_accum):
    """5 steps with dropout, a rate that changes every step and the model
    EMA: the graph route (one warm-up step, then replays) equals eager bit
    for bit, the generator included."""
    cuda = deterministic
    batches = [_route_batch(cuda)] * 5
    le, se, _ = _run(cuda, ["eager"] * 5, batches, grad_accum)
    lg, sg, steps = _run(cuda, ["graph"] * 5, batches, grad_accum)
    assert le == lg
    _assert_same(se, sg)
    assert list(steps["graph"].replays.values()) == [4]
    assert steps["graph"].counted() == 2


def test_mixed_train_routes_are_bitwise_all_eager(deterministic):
    cuda = deterministic
    batches = [_route_batch(cuda, seed=i) for i in range(5)]
    le, se, _ = _run(cuda, ["eager"] * 5, batches)
    lm, sm, steps = _run(cuda, ["eager", "graph", "graph", "eager", "graph"], batches)
    assert le == lm
    _assert_same(se, sm)
    assert list(steps["graph"].replays.values()) == [2]


def test_graph_route_resume_is_bitwise(deterministic):
    """The state after step 2 saved, two more steps, then loaded back in
    place (the generator by ``set_state``) and three steps replayed: the
    uninterrupted run's bits."""
    cuda = deterministic
    batches = [_route_batch(cuda, seed=i) for i in range(5)]
    le, se, _ = _run(cuda, ["eager"] * 5, batches)
    lr_, sr, steps = _run(cuda, ["graph"] * 5, batches, restore_at=(2, 4))
    assert le == lr_
    _assert_same(se, sr)
    assert list(steps["graph"].replays.values()) == [6]


def test_second_input_shape_keeps_the_first_graph(deterministic):
    """A larger batch captured after the first graph (larger reduce plans),
    then the first graph replayed: every step bit for bit eager."""
    cuda = deterministic
    batches = [_route_batch(cuda, n, seed=i) for i, n in enumerate((8, 16, 8, 16, 8))]
    le, se, _ = _run(cuda, ["eager"] * 5, batches)
    lg, sg, steps = _run(cuda, ["graph"] * 5, batches)
    assert le == lg
    _assert_same(se, sg)
    assert sorted(steps["graph"].replays.values()) == [1, 2]


def test_compile_train_route_within_the_fp32_bars(cuda):
    """One fp32 step on the compile route (Inductor) against eager from the
    same weights, held to chip_smoke.py's bars for a step whose sums run in
    another order: loss 1e-5 relative; the step's BN moments (EMA decay 0,
    two-pass statistics, so that no variance is the difference of two larger
    sums) 1e-5, each mean in units of its channel's standard deviation and
    each variance relative; the update within 1e-2 relative RMS or 4 times
    the eager step's own move when its images change by one ulp. The dw
    weight gradient keeps TF32 off inside its op."""
    torch._dynamo.reset()
    x, y = _route_batch(cuda)
    nudged = x * (1 + 2.0 ** -23 * (torch.randint(0, 2, x.shape, device=cuda) * 2 - 1))
    out = {}
    for name, route, images in (("eager", "eager", x), ("moved", "eager", nudged),
                                ("compile", "compile", x)):
        model, tx, state = _route_setup(cuda, dtype=torch.float32, dropout=0.0, lr=1e-3,
                                        bn_momentum=0.0, bn_stats="two_pass")
        p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        before = bn_bwd_reduce.launches
        state, metrics = make_train_step(model, tx, 0.1, route=route)(state, images, y)
        torch.cuda.synchronize()
        assert bn_bwd_reduce.launches - before == 35
        out[name] = (float(metrics["loss"]), p0,
                     {n: p.detach().clone() for n, p in model.named_parameters()},
                     dict(model.named_buffers()))
    (le, p0, pe, be), (_, _, pm, _), (lc, _, pc, bc) = out["eager"], out["moved"], out["compile"]
    assert abs(lc - le) <= 1e-5 * abs(le)
    _close_moments(bc, be, 1e-5)

    def rel_rms(pa):
        num = sum(float(((pa[n] - pe[n]) ** 2).sum()) for n in pe)
        return (num / sum(float(((pe[n] - p0[n]) ** 2).sum()) for n in pe)) ** 0.5

    assert rel_rms(pc) <= max(1e-2, 4 * rel_rms(pm))
    torch._dynamo.reset()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_opcheck_bn_ops_on_cuda(cuda, dtype):
    x, dy, ref, (mean, inv, gamma, beta) = _bn_case(cuda, (3, 9, 9, 24), dtype, seed=6)
    torch.library.opcheck(torch.ops.mnasnet_tpu_torch.bn_bwd_reduce.default,
                          (x, dy, mean, inv, gamma, beta))
    dg, db = bn_bwd_reduce(x, dy, mean, inv, gamma, beta)
    torch.library.opcheck(torch.ops.mnasnet_tpu_torch.bn_bwd_dx.default,
                          (x, dy, mean, inv, gamma, beta, dg, db, 3 * 81))


def test_failed_capture_raises(cuda):
    """A device part that reads a value on the host cannot be captured: the
    graph route raises, and nothing runs eagerly in its place."""
    import types

    from mnasnet_tpu_torch.utils.routing import TrainRouted

    state = types.SimpleNamespace(step=0, generator=torch.Generator(device=cuda))
    calls = []

    def device_step(images, labels, generator):
        calls.append(torch.cuda.is_current_stream_capturing())
        return {"loss": images.sum() * float(labels.sum())}

    steps = types.SimpleNamespace(device=cuda, inputs=lambda x, y: (x, y),
                                  host=lambda st: None, device_step=device_step)
    routed = TrainRouted(steps, "graph")
    x, y = torch.ones(4, 2, device=cuda), torch.ones(4, device=cuda)
    with pytest.raises(RuntimeError):
        routed(state, x, y)
    assert calls == [False, True] and not routed._cache
    torch.cuda.synchronize()


@pytest.mark.parametrize("route", ["train", "serve"])
def test_graph_capture_survives_a_collection_of_a_dead_graph(cuda, route):
    """An earlier CUDA graph whose last reference sits in a reference cycle
    that turns into garbage while the next graph captures, with the
    collector set to run at every allocation: collecting it inside the
    capture would destroy that graph there (an error that loses the
    capture), so the routes keep the collector off while they capture; the
    step and the forward then run and replay."""
    from mnasnet_tpu_torch.train.steps import make_predict_fn
    from mnasnet_tpu_torch.utils.routing import BatchRouted

    dead = torch.cuda.CUDAGraph()
    x = torch.zeros(4, device=cuda)
    with torch.cuda.graph(dead):
        x.add_(1)
    holder = {"graph": dead}
    del dead

    def dropping(fn):
        def call(*a):
            if torch.cuda.is_current_stream_capturing() and holder:
                cycle = [holder.pop("graph")]
                cycle.append(cycle)
                del cycle
            return fn(*a)
        return call

    model, tx, state = _route_setup(cuda)
    images, labels = _route_batch(cuda)
    thresholds = gc.get_threshold()
    gc.set_threshold(1)
    try:
        if route == "train":
            step = make_train_step(model, tx, 0.1, route="graph")
            step._steps.device_step = dropping(step._steps.device_step)
            for _ in range(2):
                state, metrics = step(state, images, labels)
            out = metrics["loss"]
        else:
            fn = BatchRouted(dropping(make_predict_fn(model)), route_for=lambda b: "graph")
            for _ in range(2):
                out = fn(images)
        torch.cuda.synchronize()
    finally:
        gc.set_threshold(*thresholds)
    assert not holder and bool(torch.isfinite(out).all())


def _port_spans(prof, device_side=False):
    """The port's spans (``mnasnet.*``) in start order, host side (or the
    device side's shadows of them), as (name, start, end, event)."""
    from torch.autograd import DeviceType

    want = DeviceType.CUDA if device_side else DeviceType.CPU
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e)
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == want and e.name().startswith("mnasnet.")]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _children(spans, parent):
    return [[n for n, s, e, _ in spans if n != parent and a <= s and e <= b]
            for name, a, b, _ in spans if name == parent]


def test_graph_route_spans_agree_with_the_counters(cuda):
    """Under the profiler, the graph routes: a key's first call holds its
    build (warm-up and capture), and every serving call a replay and a copy
    out; the train step's first call of a shape its build, each later one a
    replay and a copy out. The replay spans count the ``replays`` counters.
    A span's shadow on the device's timeline is an annotation, not a
    kernel."""
    from torch.profiler import ProfilerActivity, profile

    from mnasnet_tpu_torch.train.steps import make_predict_fn
    from mnasnet_tpu_torch.utils.routing import BatchRouted

    model, tx, state = _route_setup(cuda)
    routed = BatchRouted(make_predict_fn(model), route_for=lambda bs: "graph")
    step = make_train_step(model, tx, 0.1, route="graph")
    g = torch.Generator(device=cuda).manual_seed(0)
    xs = [torch.randn(n, 64, 64, 3, device=cuda, generator=g) for n in (4, 4, 8, 4)]
    images, labels = _route_batch(cuda)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for x in xs:
            routed(x)
        for _ in range(3):
            state, _ = step(state, images, labels)
        torch.cuda.synchronize()
    spans = _port_spans(prof)
    serve = ["mnasnet.route.copy_in", "mnasnet.route.replay", "mnasnet.route.copy_out"]
    first = serve[:1] + ["mnasnet.route.build"] + serve[1:]
    assert _children(spans, "mnasnet.route.call") == [first, serve, first, serve]
    names = [n for n, *_ in spans]
    assert names.count("mnasnet.route.replay") == sum(routed.replays.values()) == 4
    assert names.count("mnasnet.route.call") == sum(routed.calls.values()) == 4
    head = ["mnasnet.train.copy_in", "mnasnet.train.host"]
    later = head + ["mnasnet.train.replay", "mnasnet.train.copy_out"]
    assert _children(spans, "mnasnet.train.step") == [
        head + ["mnasnet.train.build"], later, later]
    assert names.count("mnasnet.train.replay") == sum(step.replays.values()) == 2
    assert names.count("mnasnet.train.build") == len(step.calls) == 1
    shadows = _port_spans(prof, device_side=True)
    assert all(e.is_user_annotation() for *_, e in shadows)


# ------------------------------------------------------ the model knobs


def test_remat_graph_route_is_bitwise_eager_and_the_plain_step(deterministic):
    """5 steps with ``remat`` (dropout, a changing rate, the model EMA): the
    graph route bit for bit the eager ``remat`` route and the step without
    ``remat``; the dw kernel launches 17 + 16 times a counted step (each
    block's recompute), the BN backward kernels 35 times each."""
    cuda = deterministic
    batches = [_route_batch(cuda)] * 5
    lp, sp, _ = _run(cuda, ["eager"] * 5, batches)
    le, se, _ = _run(cuda, ["eager"] * 5, batches, remat=True)
    before = (dw_conv_bn_act.launches, bn_bwd_reduce.launches, bn_bwd_dx.launches)
    lg, sg, steps = _run(cuda, ["graph"] * 5, batches, remat=True)
    counted = steps["graph"].counted()
    assert (dw_conv_bn_act.launches - before[0], bn_bwd_reduce.launches - before[1],
            bn_bwd_dx.launches - before[2]) == (33 * counted, 35 * counted, 35 * counted)
    assert lp == le == lg
    _assert_same(sp, se)
    _assert_same(se, sg)


# The four stride-2 depthwise layers of mnasnet1_0@224: (H, C, k).
STRIDE_2_SHAPES = [(112, 48, 3), (56, 72, 5), (28, 240, 5), (14, 576, 5)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, (1e-4, 1e-4)),
                                       (torch.bfloat16, (2.0 ** -7, 2.0 ** -6))])
@pytest.mark.parametrize("impl", ["taps", "hybrid"])
@pytest.mark.parametrize("hw,c,k", STRIDE_2_SHAPES)
def test_taps_and_hybrid_gradients_match_the_torch_route(cuda, dtype, tol, impl, hw, c, k):
    """The forward and (dx, dw) of ``taps`` and ``hybrid`` against the torch
    route at the stride-2 shapes of mnasnet1_0@224 (batch 4), within the dw
    training op's bars (chip_smoke.py): fp32 1e-4; bf16 one ulp for y and
    dx, 2^-6 for dw, which the torch route rounds to bf16 and these routes
    sum in fp32. ``taps``' bf16 dx is autograd's of its casts: each of the
    k² taps' gradients is rounded to bf16 and summed in bf16 (as the
    reference's autodiff of ``_taps_depthwise`` does), so it is held to k²
    half-ulps, k²·2^-8."""
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(4, hw, hw, c, device=cuda, generator=g).to(dtype)
    w = torch.randn(k, k, 1, c, device=cuda, generator=g) * 0.3
    out = []
    for route in (impl, "torch"):
        xr, wr = x.detach().requires_grad_(), w.detach().requires_grad_()
        y = depthwise_conv2d(xr, wr, stride=2, impl=route)
        cot = torch.randn(y.shape, device=cuda, generator=torch.Generator(device=cuda)
                          .manual_seed(6)).to(dtype)
        out.append((y, *torch.autograd.grad(y, (xr, wr), cot)))
    (y, dx, dw), (ty, tdx, tdw) = out
    assert y.dtype == dtype and dx.dtype == dtype and dw.dtype == torch.float32
    _close(y.detach(), ty.detach(), tol[0])
    taps_bf16 = impl == "taps" and dtype == torch.bfloat16
    _close(dx, tdx, k * k * 2.0 ** -8 if taps_bf16 else tol[0])
    _close(dw, tdw, tol[1])


def test_channel_pad_64_kernel_route_matches_torch_route(cuda):
    """mnasnet0_5 with ``channel_pad=64`` (every width a multiple of 64): the
    eval forward (1 dw and 16 MBConv launches where the planner admits every
    padded block) within 1e-4 of the torch route's largest logit, and one
    fp32 train step within the kernel-vs-torch step bars."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 3, 64, 64))
                         .astype(np.float32)).to(cuda)
    ref = create_model("mnasnet0_5", num_classes=10, dw_impl="torch", channel_pad=64)
    model = create_model("mnasnet0_5", num_classes=10, dw_impl="auto", channel_pad=64)
    model.load_state_dict(ref.state_dict())
    blocks = [m for m in model.modules() if isinstance(m, InvertedResidual)]
    assert all(m.mid_ch % 64 == 0 for m in blocks)
    before = (dw_conv_bn_act.launches, mbconv_fused.launches)
    with torch.no_grad():
        out = model(x)
        torch.cuda.synchronize()
        fused = mbconv_fused.launches - before[1]
        assert dw_conv_bn_act.launches - before[0] == 1 + 16 - fused
        _close(out, ref(x), 1e-4)
    rng = np.random.default_rng(5)
    images = rng.standard_normal((8, 64, 64, 3)).astype(np.float32)
    labels = rng.integers(0, 10, 8)
    steps = []
    for route in ("kernel", "torch"):
        m = create_model("mnasnet0_5", num_classes=10, dropout=0.0, dw_impl=route,
                         bn_bwd=route, bn_ema="external", stem_s2d=True, seed=2,
                         channel_pad=64)
        tx = create_optimizer("rmsprop", 1e-4, fused="small")
        state = TrainState.create(m, tx)
        state, metrics = make_train_step(m, tx, 0.1)(state, images, labels)
        steps.append((float(metrics["loss"]), m.state_dict()))
    (lk, sk), (lt, st) = steps
    assert abs(lk - lt) <= 1e-5 * abs(lt)
    _close_moments(sk, st, 1e-5)
    for k in st:
        if not k.endswith(("running_mean", "running_var", "num_batches_tracked")):
            torch.testing.assert_close(sk[k], st[k], rtol=5e-3, atol=1e-4)


def test_channel_pad_the_kernel_route_cannot_take_raises_on_the_card(cuda):
    """``auto`` with widths the dw kernel cannot take raises at the first
    forward of a CUDA tensor, naming ``channel_pad``; it never swaps the
    route."""
    model = create_model("mnasnet0_35", channel_pad=12)
    with pytest.raises(ValueError, match="channel_pad=12"):
        model(torch.zeros(1, 3, 32, 32, device=cuda))
    with torch.no_grad():
        create_model("mnasnet0_35", channel_pad=12, dw_impl="torch", bn_bwd="torch")(
            torch.zeros(1, 3, 32, 32, device=cuda))


# ------------------------------------------- the data-parallel graph route


@pytest.fixture
def nccl_world1(deterministic, tmp_path):
    """A one-rank NCCL group in this process (``file://`` rendezvous) and its
    replica handle; deterministic algorithms on."""
    import torch.distributed as dist

    from mnasnet_tpu_torch.parallel import Replicas, close

    cuda = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'rendezvous'}",
                            world_size=1, rank=0)
    replicas = Replicas(0, 1, cuda)
    try:
        yield cuda, replicas
    finally:
        close(replicas)


def _dp_run(cuda, replicas, route, kind, steps=3):
    """``steps`` data-parallel steps (``kind``: sync, local or sync_remat) on
    ``route`` from the same weights, with dropout, a changing rate and the
    model EMA; the losses, the state, the routed step and the collectives
    the helpers counted."""
    from mnasnet_tpu_torch.models.layers import set_replicas
    from mnasnet_tpu_torch.train.steps import make_local_bn_train_step

    model, tx, state = _route_setup(cuda, remat=kind == "sync_remat")
    if kind == "local":
        step = make_local_bn_train_step(model, tx, 0.1, replicas, route=route)
    else:
        set_replicas(model, replicas)
        step = make_train_step(model, tx, 0.1, replicas=replicas, route=route)
    batch = _route_batch(cuda)
    before = replicas.collectives
    losses = []
    for _ in range(steps):
        state, metrics = step(state, *batch)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    return ([float(v) for v in losses], _snapshot(model, tx, state), step,
            replicas.collectives - before, model)


@pytest.mark.parametrize("kind", ["sync", "local", "sync_remat"])
def test_nccl_graph_route_is_bitwise_eager(nccl_world1, kind):
    """World 1 over NCCL, 3 steps with dropout, a changing rate and the model
    EMA: the graph route (the warm-up step, the capture with the
    collectives inside, two replays) equals the eager data-parallel step bit
    for bit, the BN buffers with ``num_batches_tracked``, the optimizer
    state and the generator included; the helpers count the collectives of
    the warm-up and the capture, none of a replay."""
    from mnasnet_tpu_torch.train.steps import step_collectives

    cuda, replicas = nccl_world1
    le, se, eager, ce, model = _dp_run(cuda, replicas, "eager", kind)
    lg, sg, graph, cg, _ = _dp_run(cuda, replicas, "graph", kind)
    assert le == lg
    _assert_same(se, sg)
    assert list(graph.replays.values()) == [2] and graph.counted() == 2
    per_step = step_collectives(model, sync_bn=kind != "local")
    planes = len({(64 // s) ** 2 for s in (2, 4, 8, 16, 32)}) if kind != "local" else 0
    assert ce == 3 * per_step + planes  # the eager run met the plane sizes first
    assert cg == 2 * per_step


def test_nccl_replicas_take_the_graph_route_by_default(nccl_world1, monkeypatch):
    from mnasnet_tpu_torch.models.layers import set_replicas
    from mnasnet_tpu_torch.train.steps import make_local_bn_train_step
    cuda, replicas = nccl_world1
    env = "MNASNET_TPU_TORCH_ROUTE"
    monkeypatch.delenv(env, raising=False)
    model, tx, _ = _route_setup(cuda)
    assert make_local_bn_train_step(model, tx, 0.1, replicas).route == "graph"
    set_replicas(model, replicas)
    assert make_train_step(model, tx, 0.1, replicas=replicas).route == "graph"
    monkeypatch.setenv(env, "eager")
    assert make_train_step(model, tx, 0.1, replicas=replicas).route == "eager"
    with pytest.raises(ValueError, match="compile"):
        make_train_step(model, tx, 0.1, replicas=replicas, route="compile")


CLOSE_BOUND_S = 300


@pytest.mark.parametrize("world", [1, 2])
def test_close_returns_while_an_exception_holds_a_captured_step(cuda, tmp_path, world):
    """A rank raises after its graph-route step captured the group's
    collectives, and ``parallel.close`` runs in a ``finally`` while the
    exception's traceback still holds the step (``tests/torch_close_worker.py``).
    NCCL's ``destroy_process_group`` waits for every graph that captured the
    group; ``close`` resets the graphs the replicas registered, so each rank
    closes and exits with the exception within the bound. Over one rank
    NCCL captures nothing for an in-place sum; over two (two cards) the
    graph holds NCCL's kernels."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    if torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} CUDA devices")
    repo = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(repo)}
    procs = [subprocess.Popen(
        [sys.executable, str(repo / "tests" / "torch_close_worker.py"), str(rank), str(world),
         str(tmp_path / "rendezvous")], cwd=repo, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in range(world)]
    try:
        outs = [p.communicate(timeout=CLOSE_BOUND_S) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert f"rank {rank}: 1 replay, 1 graph registered" in out, (out, err)
        assert f"rank {rank}: closed" in out, (out, err)
        assert p.returncode == 1 and "Raised: raised past the capture" in err, err


def test_a_replay_that_holds_collectives_is_watched_before_the_host_blocks(cuda, tmp_path):
    """Each replay of a graph-route step over NCCL puts an event behind it
    for the host's deadline (``Replicas.watch``), so a replay that spins on
    a dead peer is held to the timeout whatever the host blocks in next. A
    stand-in step that sleeps on the card and all-reduces, captured over a
    one-rank NCCL group and replayed: right after the call the deadline's
    newest event is the replay's and has not completed; after a
    synchronize it has, and nothing ended the process."""
    from types import SimpleNamespace

    from mnasnet_tpu_torch.parallel import dist as pdist
    from mnasnet_tpu_torch.utils.routing import TrainRouted

    dev = torch.device("cuda", torch.cuda.current_device())
    pdist.join_group("nccl", f"file://{tmp_path / 'rendezvous'}", 1, 0)
    replicas = pdist.Replicas(0, 1, dev)
    exits = []
    replicas.deadline = pdist.Deadline(0, dev, limit_s=600.0, exit=exits.append)

    class Steps:
        device = dev

        def __init__(self):
            self.replicas = replicas

        def inputs(self, images, labels):
            return images, labels

        def host(self, state):
            pass

        def device_step(self, images, labels, generator):
            torch.cuda._sleep(2_000_000_000)  # ~1 s of clock cycles
            total = images.sum().reshape(1)
            pdist.all_reduce_sum_([total], replicas, "all_reduce (the step)")
            return {"loss": total}

    try:
        step = TrainRouted(Steps(), "graph")
        state = SimpleNamespace(generator=torch.Generator(device=dev))
        images, labels = torch.ones(4, 8, device=dev), torch.zeros(4, device=dev)
        step(state, images, labels)  # the warm-up and the capture
        torch.cuda.synchronize()
        _, metrics = step(state, images, labels)  # a replay
        at, event, what = replicas.deadline._pending[-1]
        assert what == "the replayed train step" and not event.query()
        torch.cuda.synchronize()
        assert event.query() and float(metrics["loss"]) == 32.0 and exits == []
        assert step.replays[next(iter(step.replays))] == 1
    finally:
        pdist.close(replicas)


# ---- the measurement tools (mnasnet_tpu_torch/tools), each at a small size --------

SERVING_LAUNCHES = {"dw_conv_bn_act": 1, "mbconv_block": 16}


def _tool(module, tmp_path, *argv) -> dict:
    import json

    out = tmp_path / "out.json"
    assert module.main(["--out", str(out), *argv]) == 0
    data = json.loads(out.read_text())
    assert data["device"].startswith("cuda") and data["card"] == torch.cuda.get_device_name(0)
    assert data["nvidia_smi"] and data["power_limit"] and data["cuda"] == torch.version.cuda
    return data


def test_tool_memory_probe(cuda, tmp_path):
    from mnasnet_tpu_torch.tools import memory_probe

    data = _tool(memory_probe, tmp_path, "--arch", "mnasnet0_35", "--image-size", "96",
                 "--batch-sizes", "128", "--accums", "1,2", "--repeats", "2",
                 "--target-ms", "50")
    rows = {r["grad_accum"]: r for r in data["rows"]}
    assert sorted(rows) == [1, 2] and data["route"] == "graph"
    for k, row in rows.items():
        assert row["oom"] is False and len(row["ms_runs"]) == 2 and row["ms_per_step"] > 0
        assert row["peak_allocated_gb"] > 0 and row["peak_reserved_gb"] >= 0
        assert row["launches_per_step"] == {"dw_conv_bn_act": 17 * k, "mbconv_block": 0,
                                            "bn_bwd_reduce": 35 * k, "bn_bwd_dx": 35 * k,
                                            "bn_fwd_stats": 35 * k, "bn_relu_apply": 35 * k}
    assert rows[2]["saved_activation_bytes"] <= 0.55 * rows[1]["saved_activation_bytes"]
    assert rows[2]["peak_allocated_gb"] < rows[1]["peak_allocated_gb"]


def test_tool_bench_latency(cuda, tmp_path):
    from mnasnet_tpu_torch.tools import bench_latency

    data = _tool(bench_latency, tmp_path, "--arch", "mnasnet0_35", "--image-size", "96",
                 "--batches", "1,8", "--repeats", "2", "--target-ms", "20")
    for row in data["table"]:
        assert row["launches_per_forward"] == {
            "kernel": SERVING_LAUNCHES, "torch": {"dw_conv_bn_act": 0, "mbconv_block": 0}}
        for impl in ("kernel", "torch"):
            for route in ("eager", "graph"):
                assert row[f"{impl}_{route}_ms"] > 0
        assert row["kernel_route"] in ("eager", "graph") and row["kernel_speedup"] > 0


def test_tool_export_latency(cuda, tmp_path):
    from mnasnet_tpu_torch.tools import export_latency

    data = _tool(export_latency, tmp_path, "--arch", "mnasnet0_35", "--image-size", "96",
                 "--batches", "1,8", "--routes", "eager,graph", "--repeats", "2",
                 "--target-ms", "20")
    for summary in data["by_batch"]:
        assert summary["eager_bitwise"]
        assert summary["artifact_launches_per_call"] == SERVING_LAUNCHES
        assert summary["fastest_route"] in ("eager", "graph")
    assert {(r["batch"], r["route"]) for r in data["rows"]} == \
        {(1, "eager"), (1, "graph"), (8, "eager"), (8, "graph")}
    for row in data["rows"]:
        assert row["live_ms"] > 0 and row["artifact_ms"] > 0
        assert row["artifact_vs_live_pct"] is not None


def test_tool_e2e_infer(cuda, tmp_path):
    from mnasnet_tpu_torch.tools import e2e_infer

    data = _tool(e2e_infer, tmp_path, "--arch", "mnasnet0_35", "--image-size", "96",
                 "--batch-size", "16", "--n-images", "64", "--workers", "1",
                 "--decoders", "pil", "--repeats", "1")
    assert data["device_only_ips"] > 0
    (row,) = data["table"]
    assert row["e2e_ips"] > 0 and row["loader_only_ips"] > 0 and row["fallback_count"] == 0
    assert data["best"] == row


def test_tool_sweep_grid(cuda, tmp_path):
    from mnasnet_tpu_torch.tools import sweep_grid

    data = _tool(sweep_grid, tmp_path, "--alphas", "0.35", "--sizes", "96",
                 "--batch-size", "8", "--train", "--repeats", "2", "--target-ms", "20")
    (row,) = data["rows"]
    assert row["refused"] == [] and row["fused_mbconv_blocks"] == 16
    assert row["dw_launches"] == 1
    for impl in ("kernel", "torch"):
        assert row[f"infer_{impl}_ips"] > 0 and row[f"train_{impl}_ips"] > 0
        assert row[f"train_{impl}_peak_allocated_gb"] > 0


@pytest.fixture(scope="module")
def smoke_states(tmp_path_factory):
    """Train-smoke state files written on the card, by compute dtype: α 0.35,
    32 px, one epoch of 4 steps with the model EMA."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mnasnet_tpu_torch.tools import train_smoke

    work = tmp_path_factory.mktemp("smoke")
    states = {}
    for dtype in ("bfloat16", "float32"):
        states[dtype] = work / f"{dtype}.pt"
        rc = train_smoke.main(["--image-size", "32", "--batch-size", "16", "--train-size", "64",
                               "--val-size", "32", "--epochs", "1", "--workers", "2",
                               "--dtype", dtype, "--model-ema", "0.999", "--bn-recalibrate",
                               "--json", str(work / f"{dtype}.json"),
                               "--state-file", str(states[dtype])])
        assert rc in (0, 1)
    return states


def test_smoke_state_reloads_on_the_card_and_the_cpu(cuda, smoke_states):
    from mnasnet_tpu_torch.tools import train_smoke

    path = smoke_states["bfloat16"]
    saved = train_smoke.load_state(str(path))
    on_card = torch.load(path, map_location="cuda", weights_only=True)
    for name, t in saved["model"].items():
        assert t.device.type == "cpu" and on_card["model"][name].device.type == "cuda"
        assert torch.equal(on_card["model"][name].cpu(), t), name
    model = create_model("mnasnet0_35", device=cuda, num_classes=10, dtype=torch.bfloat16,
                         bn_ema="external")
    model.load_state_dict(on_card["model"])
    cpu_model = create_model("mnasnet0_35", device="cpu", num_classes=10, bn_ema="external")
    cpu_model.load_state_dict(saved["model"])
    for (name, a), b in zip(model.state_dict().items(), cpu_model.state_dict().values()):
        assert torch.equal(a.cpu(), b), name
    ema = saved["optimizer"]["ema_params"]
    assert all(torch.equal(on_card["optimizer"]["ema_params"][n].cpu(), t)
               for n, t in ema.items())
    assert saved["next_epoch"] == 1 and saved["train_state"]["step"] == 4


def _pooled_error(pooled: dict, ref: dict) -> float:
    """Relative RMS of ``pooled`` against ``ref`` over every site, each
    variance in units of the site's largest reference variance and each
    mean in units of its square root."""
    num = den = 0.0
    for name, r in ref.items():
        var = float(ref[name.rpartition(".")[0] + ".running_var"].max())
        scale = var if name.endswith("running_var") else var ** 0.5
        num += float(((pooled[name].cpu().double() - r.double()) / scale).pow(2).sum())
        den += float((r.double() / scale).pow(2).sum())
    return (num / den) ** 0.5


def _as_float32(path, out):
    """A copy of a state file whose run identity says float32: the same
    weights, scored by the forensics in fp32."""
    import json

    from mnasnet_tpu_torch.tools import train_smoke

    saved = train_smoke.load_state(str(path))
    cfg = json.loads(saved["config_key"])
    saved["config_key"] = json.dumps(dict(sorted({**cfg, "dtype": "float32"}.items())))
    torch.save(saved, out)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bn_forensics_on_the_card_matches_the_cpu(cuda, smoke_states, tmp_path, dtype):
    """The same state's forensics on the card and on the CPU. fp32: each
    pooled statistic and each site median within 1e-4 of its scale (the
    site's largest pooled variance, or its square root for a mean; 1 for a
    median), chip_smoke.py's fp32 bar for the whole model. bf16: its bar
    for the whole model, against the fp32 forensics of the same weights:
    the card's relative RMS error at most 1.25 times the CPU's bf16 plain
    versions' plus 0.01, for the pooled statistics and for each summary
    median."""
    from mnasnet_tpu_torch.tools import bn_forensics

    def run(path, device):
        return bn_forensics.forensics(str(path), 2, torch.device(device), workers=2)

    path = smoke_states[dtype]
    (gpu, parts_gpu), (cpu, parts_cpu) = run(path, "cuda"), run(path, "cpu")
    assert gpu["summary"]["sites"] == cpu["summary"]["sites"] == 52
    assert set(gpu["controls_val_top1"]) == set(cpu["controls_val_top1"])
    assert gpu["card"] == torch.cuda.get_device_name(0) and gpu["nvidia_smi"]
    keys = [k for k in cpu["summary"] if k != "sites"]
    if dtype == "float32":
        assert _pooled_error(parts_gpu[1], parts_cpu[1]) <= 1e-4
        for key in keys:
            assert abs(gpu["summary"][key] - cpu["summary"][key]) <= 1e-4 * max(
                1.0, abs(cpu["summary"][key])), key
        return
    ref, parts_ref = run(_as_float32(path, tmp_path / "fp32.pt"), "cpu")
    card_err = _pooled_error(parts_gpu[1], parts_ref[1])
    plain_err = _pooled_error(parts_cpu[1], parts_ref[1])
    assert card_err <= 1.25 * plain_err + 0.01, (card_err, plain_err)
    for key in keys:
        r = ref["summary"][key]
        assert abs(gpu["summary"][key] - r) <= 1.25 * abs(cpu["summary"][key] - r) + 0.01 * max(
            1.0, abs(r)), key


# The spatial path: each kernel on a band's window of rows (parallel/spatial.py).
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)])
@pytest.mark.parametrize("k,stride,hw,c", [(3, 1, 14, 32), (5, 1, 7, 48), (3, 2, 28, 24),
                                           (5, 2, 14, 40)])
@pytest.mark.parametrize("parts", [2, 4])
def test_dw_kernel_on_a_haloed_band_matches_plain(cuda, dtype, tol, k, stride, hw, c, parts):
    """The dw kernel on each band's window of rows (the band and its halo
    rows, clipped to the plane), cropped to the band's output rows, against
    the plain version's rows of the whole plane; bands of 7/7, 4/3 and
    shorter than the k=5 halo, at both strides."""
    from mnasnet_tpu_torch.parallel.spatial import bands, conv_windows, out_size

    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(2, hw, hw, c, device=cuda, generator=g).to(dtype)
    w = torch.randn(k, k, 1, c, device=cuda, generator=g) * 0.3
    s = torch.rand(c, device=cuda, generator=g) + 0.5
    b = torch.randn(c, device=cuda, generator=g)
    ref = dw_conv_reference(x, w, s, b, stride=stride)
    out_bands = bands(out_size(hw, k, stride), parts)
    for win, (c0, c1) in zip(conv_windows(hw, parts, k, stride), out_bands):
        if not win.count:
            continue
        y = dw_conv_bn_act(x[:, win.lo:win.hi].contiguous(), w, s, b, stride=stride)
        _close(y[:, win.first:win.first + win.count], ref[:, c0:c1], tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2.0 ** -6)])
@pytest.mark.parametrize("h,cin,cmid,cout,k,stride,res", [
    (14, 24, 72, 24, 3, 1, True), (14, 24, 72, 40, 5, 2, False), (7, 40, 240, 40, 5, 1, True),
])
def test_mbconv_kernel_on_a_haloed_band_matches_plain(cuda, dtype, tol, h, cin, cmid, cout,
                                                      k, stride, res):
    """The fused MBConv kernel on each of two bands' windows of the block's
    input (the 1x1 expand gives the dw its halo rows; the plane's edges stay
    the kernel's own zero padding), cropped, against the plain version's
    rows of the whole plane."""
    from mnasnet_tpu_torch.parallel.spatial import bands, conv_windows, out_size

    g = torch.Generator(device=cuda).manual_seed(3)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, device=cuda, generator=g) * scale

    x = r(2, h, h, cin).to(dtype)
    params = (r(cin, cmid, scale=cin ** -0.5), r(cmid).abs() + 0.5, r(cmid, scale=0.1),
              r(k, k, 1, cmid, scale=1 / k), r(cmid).abs() + 0.5, r(cmid, scale=0.1),
              r(cmid, cout, scale=cmid ** -0.5), r(cout).abs() + 0.5, r(cout, scale=0.1))
    kw = dict(kernel_size=k, stride=stride, residual=res)
    ref = mbconv_reference(x, *params, **kw)
    before = mbconv_fused.launches
    for win, (c0, c1) in zip(conv_windows(h, 2, k, stride), bands(out_size(h, k, stride), 2)):
        y = mbconv_fused(x[:, win.lo:win.hi].contiguous(), *params, **kw)
        _close(y[:, win.first:win.first + win.count], ref[:, c0:c1], tol)
    assert mbconv_fused.launches == before + 2


def test_halo_exchange_replays_from_a_captured_cuda_graph(nccl_world1):
    """The halo exchange's all-reduce (forward) and its adjoint's, over a
    one-rank NCCL group, captured in a CUDA graph: a replay gives the eager
    result bit for bit (rank 0's part of a two-band plan: its halo rows,
    which no peer fills here, are zeros)."""
    from mnasnet_tpu_torch.parallel.spatial import _gather, _scatter, conv_windows, exchange

    cuda, replicas = nccl_world1
    ex = exchange(14, conv_windows(14, 2, 5, 1), 0)
    assert ex.total > 0 and ex.bottom[1] > ex.bottom[0]
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(2, 7, 14, 24, device=cuda, generator=g).to(torch.bfloat16)

    def both(x):
        win = _gather(x, ex, replicas)
        return win, _scatter(win * 2, ex, replicas, x.shape)

    eager = both(x)
    before = replicas.collectives
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        both(x)  # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    replicas.add_graph(graph)
    with torch.cuda.graph(graph):
        captured = both(x)
    graph.replay()
    torch.cuda.synchronize()
    assert replicas.collectives == before + 4  # two each for the warm-up and the capture
    for a, b in zip(eager, captured):
        assert torch.equal(a, b)
    assert eager[0].shape[1] == 7 + 2 and not eager[0][:, 7:].any()


# ------------------------------------------------- EfficientNet's BN+SiLU regions


def _b4_shapes(size: int = 380):
    """(H, C) of the 64 BN+SiLU regions and (H, C, k, stride) of the 32
    depthwise convs of efficientnet_b4's training forward at ``size`` px,
    in order (the stem, each block's expand and dw BN, the head)."""
    from mnasnet_tpu_torch.models.efficientnet import B0_STEM, stage_table
    from mnasnet_tpu_torch.models.mnasnet import round_to_multiple_of

    def out_size(n, k, s):
        return (n + 2 * (k // 2) - k) // s + 1

    h = out_size(size, 3, 2)
    regions, dws = [(h, round_to_multiple_of(B0_STEM * 1.4, 8))], []
    table = stage_table(1.4, 1.8)
    for e, k, s, cin, cout, repeats in table:
        for j in range(repeats):
            ci, st = (cin, s) if j == 0 else (cout, 1)
            mid = round_to_multiple_of(ci * e, 8)
            if e != 1:
                regions.append((h, mid))
            dws.append((h, mid, k, st))
            h = out_size(h, k, st)
            regions.append((h, mid))
    return regions + [(h, 4 * table[-1][4])], dws


B4_REGIONS, B4_DWS = _b4_shapes()


def test_b4_shapes_are_the_models():
    assert len(B4_REGIONS) == 64 and len(B4_DWS) == 32
    assert B4_REGIONS[0] == (190, 48) and B4_REGIONS[-1] == (12, 1792)


def _silu_case(cuda, shape, dtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    c = shape[-1]
    x = (torch.randn(*shape, device=cuda, generator=g) * 2 + 0.3).to(dtype)
    dy = torch.randn(*shape, device=cuda, generator=g).to(dtype)
    gamma = torch.rand(c, device=cuda, generator=g) + 0.5
    beta = torch.rand(c, device=cuda, generator=g) - 0.5
    return x, dy, gamma, beta


@pytest.mark.parametrize("dtype,tol_dx", [(torch.float32, 1e-4), (torch.bfloat16, 2.0 ** -7)])
def test_silu_kernels_match_their_plain_versions_at_the_b4_shapes(cuda, dtype, tol_dx):
    """The SiLU instantiations of the apply, reduce and dx kernels at each
    distinct BN+SiLU region shape of efficientnet_b4@380 (batch 2) against
    their plain versions on the same inputs, at the ReLU kernels'
    tolerances (the apply within one rounding of the output dtype), each
    counted once under its activation and not under ReLU's."""
    ops = (bn_relu_apply, bn_bwd_reduce, bn_bwd_dx)
    for i, (h, c) in enumerate(sorted(set(B4_REGIONS))):
        x, dy, gamma, beta = _silu_case(cuda, (2, h, h, c), dtype, seed=i)
        mean, var = batch_moments(x, "one_pass")
        vecs = (mean, torch.rsqrt(var + 1e-3), gamma, beta)
        before = [dict(op.launches_by_act) for op in ops]
        y = bn_relu_apply(x, *vecs, act="silu")
        dg, db = bn_bwd_reduce(x, dy, *vecs, act="silu")
        dx = bn_bwd_dx(x, dy, *vecs, dg, db, act="silu")
        torch.cuda.synchronize()
        assert [(op.launches_by_act["silu"] - b["silu"], op.launches_by_act["relu"] - b["relu"])
                for op, b in zip(ops, before)] == [(1, 0)] * 3
        _close(y, bn_bwd.bn_relu_apply_reference(x, *vecs, act="silu"),
               2.0 ** -8 if dtype == torch.bfloat16 else 1e-6)
        rdg, rdb = bn_bwd_reduce_reference(x, dy, *vecs, act="silu")
        _close(dg, rdg, 1e-4)
        _close(db, rdb, 1e-4)
        assert dx.dtype == dtype and dx.is_contiguous()
        _close(dx, bn_bwd_dx_reference(x, dy, *vecs, rdg, rdb, act="silu"), tol_dx)
        assert torch.equal(dx, bn_bwd_dx(x, dy, *vecs, dg, db, act="silu"))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, (1e-5, 1e-4)),
                                       (torch.bfloat16, (2.0 ** -6, 2.0 ** -6))])
def test_bn_silu_region_matches_autograd_at_the_b4_shapes(cuda, dtype, tol):
    """The BN+SiLU region (stats and SiLU apply forward, SiLU reduce and dx
    backward) at each of efficientnet_b4's 64 region shapes (batch 2)
    against float64 autograd of the plain forward, silu((x - μ)·rsqrt(σ² +
    ε)·γ + β) with batch statistics, on the same x. In fp32 y within a few
    roundings and dx, dγ, dβ at the ReLU region's tolerance; in bf16 all
    within 2^-6 of the largest value: the forward's z = x·a + b is two bf16
    ops (as the ReLU region's and the plain forward's), whose roundings are
    of x·a, larger than y where β cancels the mean, and the kernels take
    SiLU's derivative at that rounded z."""
    tol_y, tol_g = tol
    counters = (bn_fwd_stats, bn_relu_apply, bn_bwd_reduce, bn_bwd_dx)
    for i, (h, c) in enumerate(B4_REGIONS):
        x, dy, gamma, beta = _silu_case(cuda, (2, h, h, c), dtype, seed=100 + i)
        xs, gs, bs = (t.detach().clone().requires_grad_() for t in (x, gamma, beta))
        before = [f.launches for f in counters]
        y, _, _ = bn_relu_train(xs, gs, bs, 1e-3, "one_pass", act="silu")
        y.backward(dy)
        torch.cuda.synchronize()
        assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 1, 1]
        x64, g64, b64 = (t.detach().double().requires_grad_() for t in (x, gamma, beta))
        mean = x64.mean(dim=(0, 1, 2))
        var = x64.var(dim=(0, 1, 2), unbiased=False)
        y64 = torch.nn.functional.silu((x64 - mean) * torch.rsqrt(var + 1e-3) * g64 + b64)
        y64.backward(dy.double())
        _close(y, y64, tol_y)
        _close(xs.grad, x64.grad, tol_g)
        _close(gs.grad, g64.grad, tol_g)
        _close(bs.grad, b64.grad, tol_g)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)])
def test_dw_kernel_silu_epilogue_at_the_b4_shapes(cuda, dtype, tol):
    """The dw kernel's SiLU epilogue (EfficientNet's eval forward) at each of
    efficientnet_b4's 32 depthwise shapes (batch 2) against its plain
    version, and no ReLU applied."""
    for i, (h, c, k, s) in enumerate(B4_DWS):
        x, w, scale, bias = _dw_op_case(cuda, h, c, k, dtype, batch=2, seed=i)
        before = dw_conv_bn_act.launches
        y = dw_conv_bn_act(x, w, scale, bias, stride=s, relu=False, silu=True)
        torch.cuda.synchronize()
        assert dw_conv_bn_act.launches == before + 1
        _close(y, dw_conv_reference(x, w, scale, bias, stride=s, relu=False, silu=True), tol)
        assert (y < 0).any()


def _b4(cuda, route="kernel", dtype=torch.bfloat16, **kw):
    model = create_model("efficientnet_b4", num_classes=10, dtype=dtype, bn_ema="external",
                         stem_s2d=True, seed=2, dw_impl=route, bn_bwd=route, **kw)
    tx = create_optimizer("rmsprop", 1e-4, fused="small")
    return model, tx, TrainState.create(model, tx, seed=4)


def test_efficientnet_graph_step_launches_the_silu_kernels(cuda):
    """efficientnet_b4's train step on the graph route: per counted step the
    64 BN+SiLU regions launch the stats kernel and the SiLU apply, reduce
    and dx once each, the 32 dw convs the dw kernel, no ReLU region kernel
    and no fused MBConv."""
    model, tx, state = _b4(cuda)
    step = make_train_step(model, tx, 0.1, route="graph")
    images, labels = (torch.randn(4, 64, 64, 3, device=cuda), torch.randint(0, 10, (4,),
                                                                                  device=cuda))
    ops = (bn_relu_apply, bn_bwd_reduce, bn_bwd_dx)
    before = ([dict(op.launches_by_act) for op in ops], bn_fwd_stats.launches,
              dw_conv_bn_act.launches, mbconv_fused.launches)
    for _ in range(3):
        state, metrics = step(state, images, labels)
    torch.cuda.synchronize()
    n = step.counted()
    assert n == 2 and torch.isfinite(metrics["loss"])
    assert [(op.launches_by_act["silu"] - b["silu"], op.launches_by_act["relu"] - b["relu"])
            for op, b in zip(ops, before[0])] == [(64 * n, 0)] * 3
    assert (bn_fwd_stats.launches - before[1], dw_conv_bn_act.launches - before[2],
            mbconv_fused.launches - before[3]) == (64 * n, 32 * n, 0)


def test_efficientnet_train_step_kernel_route_matches_torch_route(cuda):
    """One fp32 step of efficientnet_b4 at 64 px on the kernel route (dw
    kernel, BN+SiLU region kernels) and on the torch route, at the bars of
    the MNASNet test above (loss 1e-5, BN moments 1e-5, parameters 5e-3)."""
    rng = np.random.default_rng(6)
    images = rng.standard_normal((8, 64, 64, 3)).astype(np.float32)
    labels = rng.integers(0, 10, 8)
    out = []
    for route in ("kernel", "torch"):
        model, tx, state = _b4(cuda, route, torch.float32, dropout=0.0, stochastic_depth=0.0)
        state, metrics = make_train_step(model, tx, 0.1)(state, images, labels)
        out.append((float(metrics["loss"]), model.state_dict()))
    (lk, sk), (lt, st) = out
    assert abs(lk - lt) <= 1e-5 * abs(lt)
    _close_moments(sk, st, 1e-5)
    for k in st:
        if not k.endswith(("running_mean", "running_var", "num_batches_tracked")):
            torch.testing.assert_close(sk[k], st[k], rtol=5e-3, atol=1e-4)


def test_efficientnet_artifact_serves_on_the_card(cuda):
    """An exported efficientnet_b4 (bf16, raw uint8 input) served through
    load_serving's graph route: the live kernel-route forward's logits bit
    for bit, 32 dw launches a forward and no fused MBConv, and within the
    serving bf16 bar of the fp32 torch route."""
    from mnasnet_tpu_torch.serving import load_serving
    from mnasnet_tpu_torch.tools.export_serving import build_forward, export_artifact

    fn, x = build_forward("efficientnet_b4", 10, "bfloat16", None, 96, 4, raw_input=True,
                          device=cuda)
    predict = load_serving(export_artifact(fn, x), route="graph")
    img = torch.randint(0, 256, (4, 96, 96, 3), dtype=torch.uint8, device=cuda)
    predict(img)
    before = (dw_conv_bn_act.launches, mbconv_fused.launches)
    with torch.no_grad():
        live = fn(img)
    torch.cuda.synchronize()
    assert (dw_conv_bn_act.launches - before[0], mbconv_fused.launches - before[1]) == (32, 0)
    assert torch.equal(predict(img), live)
    ref, _ = build_forward("efficientnet_b4", 10, "float32", None, 96, 4, dw_impl="torch",
                           raw_input=True, device=cuda)
    with torch.no_grad():
        assert float((ref(img) - live).abs().max()) <= 0.06 * float(ref(img).abs().max())
